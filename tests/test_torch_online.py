"""The port's train-while-serve loop (``repro_torch.serve.online``) against
the reference's, on the CPU at a small size (G and D 1 x 32, dnnweaver,
256 rows, replay 16, 12-task waves).

- The loop's host pieces equal the reference's bit for bit, given the same
  responses, tasks and numpy rng: the hard-task buffer (admission, dedup,
  eviction, the drained task batch), ``mine_hard_examples`` (every mined
  row, and the rng's state after) and the replay dataset (its init and
  every mix-in).
- The wired-up cycle on a live front end, as the reference's
  ``tests/test_online.py`` pins it: a generation trains, checkpoints,
  swaps (params generation bumped, cache invalidated) and keeps serving;
  a corrupted checkpoint falls back to the previous generation, whose
  params attach bit for bit; a raising response listener is counted and
  does not stop the front end.  Also the trainer thread itself, and the
  launcher (``launch/online``) with a corrupted generation.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.dse_api import DSEResult as JResult
from repro.core.selector import Selection as JSelection
from repro.dataset import generator as JGEN
from repro.design_models.dnnweaver import DnnWeaverModel as JDnnWeaver
from repro.serve import online as JO
from repro.serve.request import DSEResponse as JResponse
from repro_torch.convert import g_params_from_numpy
from repro_torch.core import dse_api as API
from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core.dse_api import DSEResult
from repro_torch.core.explorer import ExplorerConfig
from repro_torch.core.selector import Selection
from repro_torch.dataset.generator import generate_dataset, generate_tasks
from repro_torch.design_models import DnnWeaverModel
from repro_torch.launch import online as launch_online
from repro_torch.serve import (DSEServer, HardReplay, HardTaskBuffer,
                               OnlineConfig, OnlineLoop, ServeConfig,
                               ServeFrontend, corrupt_checkpoint,
                               mine_hard_examples)
from repro_torch.serve.request import SOURCE_DISPATCH, SOURCE_FAILED, DSEResponse

WAIT = 120


def _resp(pkg, rid, *, satisfied, lat_obj=1.0, pow_obj=1.0, seed=0,
          net=None, failed=False):
    Resp, Res, Sel = {"ref": (JResponse, JResult, JSelection),
                      "port": (DSEResponse, DSEResult, Selection)}[pkg]
    net = np.full(3, rid, np.int64) if net is None else net
    result = None if failed else Res(
        Sel(np.zeros(3, np.int64), 2.0, 2.0, satisfied, 1),
        lat_obj, pow_obj, 0.0)
    return Resp(rid, "m", result, SOURCE_FAILED if failed else SOURCE_DISPATCH,
                net_idx=None if failed else net,
                seed=None if failed else seed)


# ---------------------------------------------------------------------------
# the host pieces, bit for bit
# ---------------------------------------------------------------------------
def _offers():
    """(rid, kwargs) of a harvest stream: hard, solved, failed, repeats of
    one task identity, a new seed for it, then enough to evict."""
    net = np.array([1, 2, 3], np.int64)
    out = [(1, dict(satisfied=False)), (2, dict(satisfied=True)),
           (3, dict(satisfied=False, failed=True)),
           (4, dict(satisfied=False, net=net, seed=7)),
           (5, dict(satisfied=False, net=net, seed=7)),
           (6, dict(satisfied=False, net=net, seed=8))]
    out += [(10 + i, dict(satisfied=False, lat_obj=float(i + 1)))
            for i in range(6)]
    return out


def test_buffer_matches_reference():
    jb, tb = JO.HardTaskBuffer(capacity=6), HardTaskBuffer(capacity=6)
    for rid, kw in _offers():
        assert tb.offer(_resp("port", rid, **kw)) == \
            jb.offer(_resp("ref", rid, **kw))
    assert tb.stats() == jb.stats()
    assert tb.stats()["deduped"] == 1 and tb.stats()["evicted"] == 3
    jt, tt = jb.take_all(), tb.take_all()
    for f in ("net_idx", "lat_obj", "pow_obj"):
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tb.take_all() is None and tb.stats() == jb.stats()


@pytest.mark.parametrize("slack", [(1.0, 1.0), (1.0, 1.2)])
def test_mined_rows_match_reference(slack):
    tasks = JGEN.generate_tasks(JDnnWeaver(), 6, seed=5, slack=slack)
    jr, tr = np.random.default_rng(1), np.random.default_rng(1)
    want = JO.mine_hard_examples(JDnnWeaver(), tasks, n_samples=64,
                                 per_task=3, rng=jr)
    got = mine_hard_examples(DnnWeaverModel(), tasks, n_samples=64,
                             per_task=3, rng=tr)
    assert got is not None and want is not None
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tr.bit_generator.state == jr.bit_generator.state
    net, cfg, lat, pw = got
    lat2, pw2 = DnnWeaverModel().evaluate_indices(net, cfg)
    np.testing.assert_array_equal(np.asarray(lat2), lat)
    np.testing.assert_array_equal(np.asarray(pw2), pw)


def test_replay_matches_reference():
    base = generate_dataset(DnnWeaverModel(), 128, seed=0)
    jrep = JO.HardReplay(JGEN.generate_dataset(JDnnWeaver(), 128, seed=0),
                         capacity=8, seed=3)
    trep = HardReplay(base, capacity=8, seed=3)

    def same():
        a, b = trep.dataset(), jrep.dataset()
        for f in ("net_idx", "cfg_idx", "latency", "power"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert a.n == b.n == 136

    same()
    marked = 1000.0 + np.arange(11)
    for rep in (trep, jrep):
        assert rep.mix_in(base.net_idx[:11], base.cfg_idx[:11], marked,
                          base.power[:11]) == 11
    same()
    assert trep.absorbed == jrep.absorbed == 11
    assert sorted(trep.dataset().latency[128:].tolist()) == \
        marked[3:].tolist()


# ---------------------------------------------------------------------------
# the wired-up cycle
# ---------------------------------------------------------------------------
def _stack(key=0):
    model = DnnWeaverModel()
    cfg = G.GANConfig(n_net=model.net_space.n_dims).scaled(
        layers=1, neurons=32, batch_size=64, lr=1e-3)
    eng = API.GANDSE(model, cfg, ExplorerConfig(prob_threshold=0.1,
                                                max_candidates=64),
                     device="cpu")
    eng.attach(generate_dataset(model, 256, seed=0), G.init_generator(
        prng.fold_in(prng.prng_key(torch.tensor(key)), 3), cfg, model.space,
        "cpu"))
    srv = DSEServer(ServeConfig(max_batch=8))
    srv.register(eng)
    return model, eng, srv


def _push_hard_wave(fe, model, n=12, seed=3, req_seed=100):
    tasks = generate_tasks(model, n, seed=seed, slack=(1.0, 1.0))
    futs = [fe.submit(model.name, tasks.net_idx[i], tasks.lat_obj[i],
                      tasks.pow_obj[i], seed=req_seed + i) for i in range(n)]
    responses = [f.result(timeout=WAIT) for f in futs]
    assert all(r.ok for r in responses)
    return tasks


OCFG = dict(min_hard=4, train_iters=2, mine_samples=64, replay_capacity=16,
            seed=0)


def test_online_generation_trains_swaps_and_invalidates(tmp_path):
    model, eng, srv = _stack()
    with ServeFrontend(srv) as fe:
        loop = OnlineLoop(fe, model.name, str(tmp_path),
                          cfg=OnlineConfig(**OCFG))
        assert loop.device == torch.device("cpu")
        tasks = _push_hard_wave(fe, model)
        assert loop.buffer.stats()["admitted"] >= 1
        gen0 = srv.params_generation(model.name)
        assert loop.run_generation()
        assert loop.generation == 1 and loop.serving_step == 1
        assert loop.counters["swaps"] == 1
        assert loop.counters["swap_fallbacks"] == 0
        assert loop.counters["mined_rows"] >= 1
        assert loop.ckpt.steps() == [1]
        assert srv.params_generation(model.name) == gen0 + 1
        assert srv.summary()["cache"]["invalidations"].get(model.name, 0) >= 1
        # what serves is what was saved: the attached params are the
        # trained ones, read back bit for bit
        for p, q in zip(eng.g_params["layers"],
                        loop._state.g_params["layers"]):
            for k in ("w", "b"):
                assert torch.equal(p[k], q[k]) and p[k] is not q[k]
        (t,) = loop.timings
        assert t["generation"] == 1 and t["serving_step"] == 1
        assert t["steps"] == 2 * (272 // 64) and t["bytes"] > 0
        assert min(t["train_s"], t["save_s"], t["restore_s"]) > 0
        f = fe.submit(model.name, tasks.net_idx[0], tasks.lat_obj[0],
                      tasks.pow_obj[0], seed=999)
        assert f.result(timeout=WAIT).ok
        m = loop.metrics()
        assert m["generation"] == 1 and m["last_error"] is None


def test_corrupt_checkpoint_falls_back_to_previous_generation(tmp_path):
    model, eng, srv = _stack()
    params0 = {"layers": [dict(p) for p in eng.g_params["layers"]]}
    ocfg = OnlineConfig(**OCFG,
                        post_checkpoint=lambda sdir: corrupt_checkpoint(sdir))
    with ServeFrontend(srv) as fe:
        loop = OnlineLoop(fe, model.name, str(tmp_path), cfg=ocfg)
        loop.start()
        loop.stop(timeout=WAIT)
        assert loop.ckpt.steps() == [0]
        tasks = _push_hard_wave(fe, model)
        assert loop.run_generation()
        assert loop.generation == 1
        assert loop.counters["swap_fallbacks"] == 1
        assert loop.serving_step == 0 and loop.timings[0]["serving_step"] == 0
        assert loop.counters["swaps"] == 1
        for p, q in zip(eng.g_params["layers"], params0["layers"]):
            for k in ("w", "b"):
                assert torch.equal(p[k], q[k])
        f = fe.submit(model.name, tasks.net_idx[0], tasks.lat_obj[0],
                      tasks.pow_obj[0], seed=999)
        assert f.result(timeout=WAIT).ok


def test_raising_listener_is_counted_not_fatal():
    model, eng, srv = _stack()
    with ServeFrontend(srv) as fe:
        fe.add_response_listener(lambda r: 1 / 0)
        t = generate_tasks(model, 1, seed=9)
        f = fe.submit(model.name, t.net_idx[0], t.lat_obj[0], t.pow_obj[0],
                      seed=5)
        assert f.result(timeout=WAIT).ok
        fm = fe.metrics()["frontend"]
        assert fm["listener_errors"] == 1
        assert "ZeroDivisionError" in fm["last_listener_error"]


def test_trainer_thread_runs_a_generation(tmp_path):
    """The loop's own thread: a hard wave in the buffer starts a
    generation in the gap after serving, and the swap lands while the
    front end keeps answering."""
    model, eng, srv = _stack()
    with ServeFrontend(srv) as fe:
        with OnlineLoop(fe, model.name, str(tmp_path),
                        cfg=OnlineConfig(**OCFG, max_generations=1)) as loop:
            _push_hard_wave(fe, model)
            import time
            end = time.monotonic() + WAIT
            while loop.generation < 1 and time.monotonic() < end:
                time.sleep(0.02)
            while loop.training and time.monotonic() < end:
                time.sleep(0.02)
            assert loop.generation == 1 and loop.serving_step == 1
            _push_hard_wave(fe, model, seed=4)
        assert loop.counters["generation_errors"] == 0
        assert loop.ckpt.steps() == [0, 1]


def test_launcher_corrupted_generation_falls_back(tmp_path):
    rep = launch_online.run([
        "--device", "cpu", "--waves", "5", "--wave-size", "12",
        "--slack", "1.0", "--min-hard", "4", "--generations", "3",
        "--corrupt-step", "2", "--train-iters", "1", "--data", "256",
        "--replay", "16", "--checkpoint-dir", str(tmp_path)])
    final = rep["final"]
    assert final["generations"] == 3 and final["swaps"] == 3
    assert final["swap_fallbacks"] == 1 and final["generation_errors"] == 0
    steps = {t["generation"]: t["serving_step"] for t in rep["timings"]}
    assert steps == {1: 1, 2: 1, 3: 3}
    assert final["checkpoint_steps"] == [1, 2, 3]
    assert rep["summary"]["pending"] == 0
    assert all(w["answered"] == 12 for w in rep["waves"])


def test_launcher_reports_a_generation_only_after_its_swap(tmp_path,
                                                          monkeypatch):
    """A generation's checkpoint and swap take time at full width (~169 MB
    at 11 x 2048): the launcher waits them out between waves and reads its
    report after the loop stops, so every trained generation it reports
    has swapped (a slow swap stands in for the large checkpoint here)."""
    import time

    real = OnlineLoop._swap

    def slow_swap(self):
        time.sleep(0.3)
        real(self)

    monkeypatch.setattr(OnlineLoop, "_swap", slow_swap)
    rep = launch_online.run([
        "--device", "cpu", "--waves", "3", "--wave-size", "12",
        "--slack", "1.0", "--min-hard", "2", "--generations", "1",
        "--train-iters", "1", "--data", "256", "--replay", "16",
        "--checkpoint-dir", str(tmp_path)])
    final = rep["final"]
    assert final["generations"] == 1 and final["swaps"] == 1
    assert not final["training"]
    assert [t["serving_step"] for t in rep["timings"]] == [1]
    assert [w["serving_step"] for w in rep["waves"]][1:] == [1, 1]
