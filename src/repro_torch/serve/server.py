"""`DSEServer`: the micro-batching serving front-end for DSE engines.

The paper reports per-query DSE latency (Table 5); a production deployment
sees many independent in-flight queries.  This server closes the gap
between single submissions and the batched exploration path on the card
(``GANDSE.explore_batch``: G through the whole-MLP kernel, then the
batched select), which takes *pre-formed* batches:

- ``submit`` admits one request (or parses a raw network description) into
  a per-model FIFO queue, answering straight from the LRU result cache
  when an identical query was already served, or coalescing onto an
  identical in-flight request so equal work is dispatched once; when a
  model's queue is at ``ServeConfig.max_queue`` the request is shed at the
  door with a REJECTED response carrying a retry-after hint (admission
  control: bounded queues instead of unbounded buffering);
- ``step`` sheds expired-deadline requests, pops one pow2-bucketed
  micro-batch from a model outside its retry-backoff window, and
  dispatches it through the engine's ``explore_tasks`` (the `DSEMethod`
  protocol) with per-request seeds, so every response is Selection
  -identical to a standalone ``explore`` call — batching is invisible to
  correctness;
- ``drain`` steps until every queue is empty (waiting out retry-backoff
  windows) and hands back the pending responses;
- ``register`` hosts one engine per design model, and ``swap`` hot-swaps a
  model's generator params via ``GANDSE.attach`` (no retrain), with that
  model's cache entries invalidated.

Failure semantics: a dispatch exception requeues the batch at the head of
its queue and arms a jittered-exponential-backoff window for that model
(no immediate re-hammering of a failing engine); a request that keeps
failing past ``max_dispatch_attempts`` gets a FAILED response instead of
wedging its queue.  After ``degrade_after`` consecutive dispatch failures
the model's dispatches fall back to the sequential route
(``explore_tasks(batched=False)``: one ``GANDSE.explore`` a task — G still
on the engine's device, then the host select; the same Selections by the
parity contract, just slower), with the batched route re-probed every
``degrade_probe_after`` successful degraded dispatches so the model
recovers as soon as it heals.  Responses computed by the fallback carry
``degraded=True``.  This is the reference's failure semantics, not a
device fallback: nothing here moves work off the card.

Threading contract: `DSEServer` itself is an event loop — submissions,
batch formation, and publication must be serialized by the caller (the
sync pump does this trivially on one thread; `repro_torch.serve.frontend`
serializes them with one lock).  The split dispatch API exists for that
front end: ``form_batch`` / ``execute_batch`` / ``publish_batch`` /
``fail_batch``, where only ``execute_batch`` (the engine call — host
batching and device compute) may safely run *outside* the caller's lock,
overlapping with concurrent submissions and formation.  Its work runs on
the card on PyTorch's current stream, which the kernel wrappers launch on,
so the serving and training threads' work meets on one stream in order;
it runs under ``torch.no_grad`` (grad mode is per thread), so a serving
forward never builds an autograd graph.
"""
from __future__ import annotations

import dataclasses
import inspect
import random
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import shard
from repro_torch.core.dse_api import DSEMethod, DSEResult, parse_network
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.serve.batcher import MicroBatch, MicroBatcher
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.request import (SOURCE_CACHE, SOURCE_COALESCED,
                                       SOURCE_DISPATCH, SOURCE_FAILED,
                                       SOURCE_REJECTED, DSERequest,
                                       DSEResponse)
from repro_torch.train.shardings import mesh_sizes


def _now() -> float:
    """Scheduling clock (deadlines, backoff windows): monotonic so a wall
    -clock step never expires or revives a request."""
    return time.monotonic()


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 64          # micro-batch cap (before pow2 padding)
    cache_capacity: int = 4096   # LRU entries; <= 0 disables result caching
    pad_pow2: bool = True        # bucket batch sizes (log2(max_batch) shapes)
    coalesce_identical: bool = True  # identical queued requests dispatch once
    response_retention: int = 4096   # newest responses kept (rid lookup AND
                                     # undrained outbox); size >= expected
                                     # per-drain volume
    max_dispatch_attempts: int = 2   # per-request cap before a FAILED response
    max_queue: int = 0           # per-model queued-request bound; a submit
                                 # past it is REJECTED with a retry-after
                                 # hint (<= 0 = unbounded, the old behavior)
    retry_backoff_base: float = 0.05  # s; first retry delay after a dispatch
                                      # failure, doubling per consecutive
                                      # failure (jittered) up to the max —
                                      # replaces the old immediate retry
    retry_backoff_max: float = 2.0
    retry_jitter: float = 0.25   # uniform +-fraction applied to each delay
                                 # (0 = deterministic, for tests)
    degrade_after: int = 3       # consecutive dispatch failures before a
                                 # model's dispatches fall back to the
                                 # sequential route (<= 0 or an engine
                                 # without the `batched=` kwarg disables
                                 # the fallback)
    degrade_probe_after: int = 4  # successful degraded dispatches between
                                  # batched-route recovery probes
    use_fused: Optional[bool] = None  # kernel-route override pushed onto
                                      # every registered engine
                                      # (`set_use_fused`; None = leave the
                                      # engine's own setting, False = the
                                      # plain versions)


class DSEServer:
    """Multi-model micro-batching DSE server (single-threaded event loop:
    submissions and dispatches interleave on the caller's thread; see the
    module docstring for the concurrent front end's split-dispatch
    contract)."""

    def __init__(self, cfg: Optional[ServeConfig] = None):
        self.cfg = cfg or ServeConfig()
        self.engines: Dict[str, DSEMethod] = {}
        self.cache = ResultCache(self.cfg.cache_capacity)
        self.batcher = MicroBatcher(self.cfg.max_batch, self.cfg.pad_pow2)
        self._next_rid = 0
        # key -> rids of identical requests riding the queued one
        self._followers: Dict[Tuple, List[int]] = {}
        # bounded rid -> response map (oldest evicted past retention), so a
        # long-lived server under sustained traffic holds steady memory
        self._responses: "OrderedDict[int, DSEResponse]" = OrderedDict()
        self._outbox: List[DSEResponse] = []
        self._attempts: Dict[int, int] = {}   # rid -> failed dispatch count
        self._consec_fail: Dict[str, int] = {}    # model -> consecutive fails
        self._backoff_until: Dict[str, float] = {}  # model -> monotonic time
        self._degraded: Dict[str, Dict] = {}  # model -> {"ok": n, "since": t}
        self._supports_batched: Dict[str, bool] = {}
        # model -> params generation: bumped by every swap()/re-register.
        # Formed batches are stamped with it (see MicroBatch.params_gen)
        # so publish_batch can tell a result was computed under params the
        # swap already retired and skip the cache put (the stale-cache
        # -after-swap race; tests/test_serve_concurrency.py pins it).
        self._params_gen: Dict[str, int] = {}
        self._rng = random.Random(0x5EED)     # backoff jitter (deterministic)
        #: response hook for the concurrent front end (called synchronously
        #: inside _respond, i.e. under whatever lock the caller holds)
        self.on_response: Optional[Callable[[DSEResponse], None]] = None
        self.stats = {
            "submitted": 0, "dispatched_rows": 0, "padded_rows": 0,
            "batches": 0, "coalesced": 0, "swaps": 0, "failed": 0,
            "dispatch_s": 0.0, "dispatch_attempts": 0, "retried": 0,
            "rejected": 0, "rejected_queue": 0, "rejected_deadline": 0,
            "degraded_entered": 0, "degraded_recovered": 0,
            "degraded_batches": 0, "probe_failures": 0,
            "stale_cache_skips": 0,
        }

    # ---- registry ----------------------------------------------------------
    def register(self, engine: DSEMethod) -> DSEMethod:
        """Host ``engine`` for its design model (one engine per model name);
        re-registering a name replaces the engine and drops its cache.
        When ``ServeConfig.use_fused`` is set, the server pushes it onto
        the engine (``set_use_fused``) so every hosted engine serves with
        one consistent kernel route."""
        name = engine.model.name
        if name in self.engines:
            # replacing an engine is a params change like any swap: retire
            # the cache entries and the generation in-flight batches carry
            self._params_gen[name] = self._params_gen.get(name, 0) + 1
            self.cache.invalidate_model(name)
        if self.cfg.use_fused is not None:
            setter = getattr(engine, "set_use_fused", None)
            if setter is not None:
                setter(self.cfg.use_fused)
        self.engines[name] = engine
        try:
            sig = inspect.signature(engine.explore_tasks)
            self._supports_batched[name] = "batched" in sig.parameters
        except (TypeError, ValueError):
            self._supports_batched[name] = False
        return engine

    def swap(self, model_name: str, ds, g_params) -> int:
        """Hot-swap a model's dataset/params via the engine's ``attach``
        (no retrain) and invalidate its cached results;
        returns the number of invalidated entries.  Queued requests are
        served by the new params — like any refresh, in-flight work lands
        on whichever params are attached at dispatch time.  Bumps the
        model's params generation, so a batch executing across the swap
        still responds but cannot re-cache its old-params result.

        On a server wrapped by a live `ServeFrontend`, call
        ``ServeFrontend.swap`` instead: this method mutates engine and
        cache state and must run under the front-end lock (repro-lint
        GL111 flags direct ``.server.swap(...)`` calls)."""
        self.engines[model_name].attach(ds, g_params)
        self.stats["swaps"] += 1
        self._params_gen[model_name] = self._params_gen.get(model_name, 0) + 1
        return self.cache.invalidate_model(model_name)

    def params_generation(self, model_name: str) -> int:
        """Monotonic per-model params version (0 until the first swap)."""
        return self._params_gen.get(model_name, 0)

    # ---- admission ---------------------------------------------------------
    def submit(self, model_name: str, net_idx, lat_obj: float,
               pow_obj: float, seed: int = 0,
               deadline: Optional[float] = None) -> int:
        """Admit one DSE query; returns its request id.  The response
        appears on the next ``drain``/``step`` that covers it (immediately
        for a cache hit, a queue-bound rejection, or an already-expired
        deadline).  ``deadline`` is a ``time.monotonic()`` instant: the
        request is shed (REJECTED, with a retry-after hint) if it is still
        queued when the deadline passes."""
        assert model_name in self.engines, f"no engine for '{model_name}'"
        # copy: asarray aliases an int64 caller buffer, and the request's
        # cache/coalescing key is recomputed from net_idx at dispatch — a
        # caller-side mutation must not desync it (or poison the cache)
        net_idx = np.array(net_idx, np.int64, copy=True).reshape(-1)
        # reject at the door: a malformed request must never reach (and
        # poison) a batch — and a negative index would wrap silently in
        # numpy, exploring (and caching!) the wrong network
        net_space = self.engines[model_name].model.net_space
        if net_idx.shape[0] != net_space.n_dims:
            raise ValueError(f"net_idx has {net_idx.shape[0]} dims, "
                             f"'{model_name}' expects {net_space.n_dims}")
        sizes = np.asarray(net_space.group_sizes)
        if np.any((net_idx < 0) | (net_idx >= sizes)):
            raise ValueError(f"net_idx {net_idx.tolist()} out of range for "
                             f"'{model_name}' (sizes {sizes.tolist()})")
        rid = self._next_rid
        self._next_rid += 1
        self.stats["submitted"] += 1
        req = DSERequest(rid=rid, model_name=model_name, net_idx=net_idx,
                         lat_obj=float(lat_obj), pow_obj=float(pow_obj),
                         seed=int(seed), deadline=deadline)
        key = req.key
        hit = self.cache.get(key)
        if hit is not None:
            self._respond(DSEResponse(rid, model_name, hit, SOURCE_CACHE,
                                      net_idx=net_idx, seed=req.seed))
            return rid
        if self.cfg.coalesce_identical and key in self._followers:
            self._followers[key].append(rid)
            self.stats["coalesced"] += 1
            return rid
        if (self.cfg.max_queue > 0
                and self.batcher.pending(model_name) >= self.cfg.max_queue):
            self.stats["rejected_queue"] += 1
            self._reject(rid, model_name,
                         f"queue full ({self.cfg.max_queue} queued)",
                         self._retry_after(model_name))
            return rid
        if req.expired(_now()):
            self.stats["rejected_deadline"] += 1
            self._reject(rid, model_name, "deadline expired at admission",
                         self._retry_after(model_name))
            return rid
        self._followers[key] = []
        self.batcher.admit(req)
        return rid

    def submit_network(self, model_name: str, desc: Dict[str, float],
                       lat_obj: float, pow_obj: float, seed: int = 0,
                       deadline: Optional[float] = None) -> int:
        """Parsing-phase front door: a raw network description is snapped
        onto the model's net space (`parse_network`) before admission."""
        net_idx = parse_network(desc, self.engines[model_name].model)
        return self.submit(model_name, net_idx, lat_obj, pow_obj, seed=seed,
                           deadline=deadline)

    # ---- load shedding -----------------------------------------------------
    def shed_expired(self, now: Optional[float] = None) -> int:
        """Shed every queued request whose deadline has passed (REJECTED
        with a retry-after hint, followers included) *before* it can occupy
        a dispatch slot; returns the number of responses produced."""
        now = _now() if now is None else now
        shed = self.batcher.shed(lambda r: r.expired(now))
        n = 0
        for req in shed:
            self._attempts.pop(req.rid, None)
            hint = self._retry_after(req.model_name)
            self.stats["rejected_deadline"] += 1
            self._reject(req.rid, req.model_name,
                         "deadline expired before dispatch", hint)
            n += 1
            for rid in self._followers.pop(req.key, ()):
                self.stats["rejected_deadline"] += 1
                self._reject(rid, req.model_name,
                             "deadline expired before dispatch", hint)
                n += 1
        return n

    def reject_pending(self, error: str = "server shutting down") -> int:
        """Shed *every* queued request (followers included) with a REJECTED
        response — the shutdown path's every-request-terminates guarantee."""
        shed = self.batcher.shed(lambda r: True)
        n = 0
        for req in shed:
            self._attempts.pop(req.rid, None)
            self._reject(req.rid, req.model_name, error, None)
            n += 1
            for rid in self._followers.pop(req.key, ()):
                self._reject(rid, req.model_name, error, None)
                n += 1
        return n

    def _reject(self, rid: int, model_name: str, error: str,
                retry_after: Optional[float]) -> None:
        self.stats["rejected"] += 1
        self._respond(DSEResponse(rid, model_name, None, SOURCE_REJECTED,
                                  error=error, retry_after=retry_after))

    def _retry_after(self, model_name: str) -> float:
        """Resubmit-after hint: the queue's estimated drain time at the
        observed dispatch throughput (rough floor-guess before any
        throughput history exists)."""
        pending = self.batcher.pending(model_name)
        if self.stats["dispatch_s"] > 0 and self.stats["dispatched_rows"] > 0:
            rate = self.stats["dispatched_rows"] / self.stats["dispatch_s"]
            est = (pending + 1) / max(rate, 1e-9)
        else:
            est = 0.05 * (pending + 1)
        return float(min(max(est, self.cfg.retry_backoff_base, 1e-3), 60.0))

    # ---- dispatch ----------------------------------------------------------
    def form_batch(self, model_name: Optional[str] = None,
                   now: Optional[float] = None) -> Optional[MicroBatch]:
        """Shed expired requests, then pop the next dispatchable micro
        -batch: round-robin over models with work that are outside their
        retry-backoff window when ``model_name`` is None; a targeted pop
        bypasses the backoff window (explicit caller intent) and does not
        rotate the round-robin order.  Returns None when nothing is ready
        (idle, or every model with work is backing off)."""
        now = _now() if now is None else now
        self.shed_expired(now)
        return self._pop_ready(model_name, now)

    def _pop_ready(self, model_name: Optional[str],
                   now: float) -> Optional[MicroBatch]:
        if model_name is not None:
            return self._stamp(self.batcher.next_batch(model_name))
        for name in self.batcher.models_with_work():
            if now >= self._backoff_until.get(name, 0.0):
                return self._stamp(self.batcher.next_batch(name, rotate=True))
        return None

    def _stamp(self, batch: Optional[MicroBatch]) -> Optional[MicroBatch]:
        """Stamp a formed batch with its model's current params generation
        (a requeued-then-reformed batch gets a fresh stamp)."""
        if batch is not None:
            batch.params_gen = self._params_gen.get(batch.model_name, 0)
        return batch

    def step(self, model_name: Optional[str] = None) -> int:
        """Shed expired requests and dispatch one micro-batch (round-robin
        over models with work and outside their backoff window when
        ``model_name`` is None); returns the number of requests answered —
        shed rejections included — (0 when idle or backing off)."""
        now = _now()
        answered = self.shed_expired(now)
        batch = self._pop_ready(model_name, now)
        if batch is None:
            return answered
        return answered + self._dispatch(batch)

    def drain(self) -> List[DSEResponse]:
        """Step until every queue is empty — sleeping out retry-backoff
        windows when every model with work is inside one — then hand back
        (and clear) all responses produced since the last drain, in
        production order."""
        while True:
            if self.step() > 0:
                continue
            if self.batcher.pending() == 0:
                break
            # every model with work is inside its backoff window: wait out
            # the earliest one instead of spinning
            now = _now()
            waits = [self._backoff_until.get(m, now) - now
                     for m in self.batcher.models_with_work()]
            if waits:
                time.sleep(min(max(min(waits), 0.0),
                               self.cfg.retry_backoff_max) + 1e-4)
        out, self._outbox = self._outbox, []
        return out

    def response(self, rid: int) -> Optional[DSEResponse]:
        return self._responses.get(rid)

    def _dispatch(self, batch: MicroBatch) -> int:
        """Synchronous execute + publish (the event-loop pump).  The
        exception policy here is the original one: a failed dispatch
        requeues/fails its requests (with backoff armed) and then
        re-raises to the caller — the concurrent front end composes
        execute/fail/publish itself and swallows instead."""
        try:
            results, info = self.execute_batch(batch)
        except Exception as e:
            self.fail_batch(batch, e)
            raise
        return self.publish_batch(batch, results, info)

    @torch.no_grad()
    def execute_batch(self, batch: MicroBatch):
        """Run the engine for one formed micro-batch and return
        ``(results, info)``.  No shared serving state is mutated (route
        choice reads a snapshot of the degraded table), so the concurrent
        front end runs this *outside* its lock — device compute overlaps
        with admission and the next batch's formation.  Runs without
        autograd on whatever thread calls it.  Raises whatever the engine
        raises (route fallback exhausted): pair with ``fail_batch``."""
        engine = self.engines[batch.model_name]
        deg = self._degraded.get(batch.model_name)
        info = {"degraded": False, "probe": None, "elapsed": 0.0}
        t0 = time.perf_counter()
        if deg is None:
            results = engine.explore_tasks(batch.tasks, seed=batch.seeds)
        elif deg["ok"] >= max(self.cfg.degrade_probe_after, 1):
            # recovery probe: try the batched route again; if it is still
            # failing, fall back to the sequential route for this batch too
            try:
                results = engine.explore_tasks(batch.tasks, seed=batch.seeds)
                info["probe"] = "ok"
            except Exception as e:
                info["probe"] = "failed"
                info["probe_error"] = repr(e)
                info["degraded"] = True
                results = self._host_route(engine, batch)
        else:
            info["degraded"] = True
            results = self._host_route(engine, batch)
        info["elapsed"] = time.perf_counter() - t0
        return results, info

    def _host_route(self, engine: DSEMethod, batch: MicroBatch):
        """The graceful-degradation route: the sequential per-task loop
        (`explore_tasks(batched=False)` — Selection-identical by the
        parity contract).  Engines without the kwarg just retry the only
        route they have."""
        if self._supports_batched.get(batch.model_name, False):
            return engine.explore_tasks(batch.tasks, seed=batch.seeds,
                                        batched=False)
        return engine.explore_tasks(batch.tasks, seed=batch.seeds)

    def publish_batch(self, batch: MicroBatch, results: List[DSEResult],
                      info: Dict) -> int:
        """Publish one executed batch: cache, respond (followers included),
        clear failure bookkeeping, and apply the degraded-route state
        transition recorded by ``execute_batch``.  Mutates shared serving
        state: the front end calls it under its lock.

        When the model's params generation advanced while the batch was
        executing (a swap landed between the lock-free execute and this
        publish), the requests are still answered — in-flight work lands
        on whichever params were attached at dispatch time — but the
        results are NOT cached: the swap already invalidated the model's
        entries, and re-inserting a Selection computed under the retired
        params would serve a stale result forever."""
        name = batch.model_name
        stale = batch.params_gen != self._params_gen.get(name, 0)
        if stale:
            self.stats["stale_cache_skips"] += 1
        self.stats["dispatch_attempts"] += 1
        self.stats["dispatch_s"] += info["elapsed"]
        self.stats["batches"] += 1
        self.stats["dispatched_rows"] += batch.n_real
        self.stats["padded_rows"] += batch.padded_size - batch.n_real
        self._consec_fail.pop(name, None)
        self._backoff_until.pop(name, None)
        deg = self._degraded.get(name)
        if deg is not None:
            if info["probe"] == "ok":       # batched route healed
                self._degraded.pop(name)
                self.stats["degraded_recovered"] += 1
            elif info["probe"] == "failed":  # still down; restart probe clock
                deg["ok"] = 0
                self.stats["probe_failures"] += 1
                self.stats["degraded_batches"] += 1
            else:
                deg["ok"] += 1
                self.stats["degraded_batches"] += 1
        answered = 0
        for i, req in enumerate(batch.requests):   # padding rows discarded
            res: DSEResult = results[i]
            key = req.key
            self._attempts.pop(req.rid, None)
            if not stale:
                self.cache.put(key, res)
            self._respond(DSEResponse(req.rid, name, res, SOURCE_DISPATCH,
                                      batch.n_real,
                                      degraded=info["degraded"],
                                      net_idx=req.net_idx, seed=req.seed))
            answered += 1
            for rid in self._followers.pop(key, ()):
                # followers are key-identical to the leader, so the
                # leader's (net_idx, seed) is theirs too
                self._respond(DSEResponse(rid, name, res, SOURCE_COALESCED,
                                          batch.n_real,
                                          degraded=info["degraded"],
                                          net_idx=req.net_idx, seed=req.seed))
                answered += 1
        return answered

    def fail_batch(self, batch: MicroBatch, exc: Exception,
                   now: Optional[float] = None) -> None:
        """Record one failed dispatch: requeue the popped requests at the
        head of their queue (followers stay attached) so nothing is lost —
        except requests past ``max_dispatch_attempts``, which get a FAILED
        response instead of wedging the queue forever.  Arms the model's
        jittered-exponential retry-backoff window and, past
        ``degrade_after`` consecutive failures, flips the model onto the
        degraded sequential route (backoff skipped: the fallback route is
        presumed healthy and should run immediately)."""
        now = _now() if now is None else now
        name = batch.model_name
        self.stats["dispatch_attempts"] += 1
        k = self._consec_fail.get(name, 0) + 1
        self._consec_fail[name] = k
        entered = False
        if (self.cfg.degrade_after > 0 and k >= self.cfg.degrade_after
                and name not in self._degraded
                and self._supports_batched.get(name, False)):
            self._degraded[name] = {"ok": 0, "since": now}
            self.stats["degraded_entered"] += 1
            entered = True
        self._backoff_until[name] = now + \
            (0.0 if entered else self._backoff_delay(k))
        retry = []
        for req in batch.requests:
            n = self._attempts.get(req.rid, 0) + 1
            if n < self.cfg.max_dispatch_attempts:
                self._attempts[req.rid] = n
                retry.append(req)
            else:
                self._attempts.pop(req.rid, None)
                self._fail(req, name, exc)
        self.stats["retried"] += len(retry)
        self.batcher.requeue_front(retry)

    def _backoff_delay(self, k: int) -> float:
        """Jittered exponential backoff: base * 2^(k-1) capped at the max,
        +-retry_jitter fraction of uniform noise (desynchronizes retry
        storms across models/processes)."""
        base = max(self.cfg.retry_backoff_base, 0.0)
        delay = min(base * (2.0 ** max(k - 1, 0)), self.cfg.retry_backoff_max)
        j = min(max(self.cfg.retry_jitter, 0.0), 1.0)
        if j > 0.0:
            delay *= 1.0 + j * (2.0 * self._rng.random() - 1.0)
        return max(delay, 0.0)

    def _fail(self, req: DSERequest, model_name: str, exc: Exception) -> None:
        self.stats["failed"] += 1
        self._respond(DSEResponse(req.rid, model_name, None,
                                  SOURCE_FAILED, error=str(exc)))
        for rid in self._followers.pop(req.key, ()):
            self.stats["failed"] += 1
            self._respond(DSEResponse(rid, model_name, None,
                                      SOURCE_FAILED, error=str(exc)))

    def _respond(self, resp: DSEResponse) -> None:
        self._responses[resp.rid] = resp
        while len(self._responses) > max(self.cfg.response_retention, 1):
            self._responses.popitem(last=False)
        self._outbox.append(resp)
        # same bound for the drain outbox: a step()/response(rid) polling
        # loop that never drains must not accumulate responses forever
        if len(self._outbox) > max(self.cfg.response_retention, 1):
            del self._outbox[0]
        if self.on_response is not None:
            self.on_response(resp)

    # ---- introspection -----------------------------------------------------
    def summary(self) -> Dict:
        s = dict(self.stats)
        s["pending"] = self.batcher.pending()
        s["cache"] = self.cache.stats()
        s["models"] = sorted(self.engines)
        s["mean_batch_size"] = (s["dispatched_rows"] / s["batches"]
                                if s["batches"] else 0.0)
        now = _now()
        s["backoff"] = {m: round(t - now, 4)
                        for m, t in self._backoff_until.items() if t > now}
        s["degraded"] = sorted(self._degraded)
        s["params_generation"] = dict(self._params_gen)
        s["inflight_attempts"] = dict(self._attempts)

        def device(e) -> Optional[torch.device]:
            d = getattr(e, "device", None)
            return None if d is None else torch.device(d)

        def engine_route(e) -> bool:
            # the route this engine's dispatches actually take: the server
            # -level flag when set, else the engine's own setting, on the
            # engine's device (the CPU never runs the kernels)
            flag = self.cfg.use_fused
            if flag is None:
                gc = getattr(e, "gan_cfg", None)
                flag = gc.use_fused if gc is not None \
                    else getattr(e, "use_fused", None)
            return _dispatch.kernel_route_active(flag, device(e))

        engines = sorted(self.engines.items())
        s["kernels"] = {
            "backend": {name: (None if device(e) is None else device(e).type)
                        for name, e in engines},
            "fused": {name: engine_route(e) for name, e in engines},
        }
        mesh = shard.get_task_mesh()
        s["sharding"] = {
            "n_shards": shard.active_n_shards(),
            "mesh": mesh_sizes(mesh) if mesh is not None else None,
            "task_axes": shard.task_axes(mesh),
        }
        return s
