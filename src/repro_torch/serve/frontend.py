"""Concurrent production front end over `DSEServer`: non-blocking submit
with futures, continuous batching, admission control, and load shedding.

The sync `DSEServer` is an event-loop pump: submissions and dispatches
interleave on one thread, so a slow dispatch stalls every caller behind
it.  `ServeFrontend` wraps one server with a two-stage pipeline:

- **submitter threads** (any number) call ``submit`` and get a
  ``concurrent.futures.Future`` resolving to the request's `DSEResponse`
  — cache hits and admission rejections resolve immediately;
- a **former** thread continuously sheds expired-deadline requests and
  forms the next pow2-bucketed micro-batch (host-side work: concat,
  padding) into a small bounded buffer;
- a **dispatcher** thread executes buffered batches through the engine
  (``DSEServer.execute_batch``, the only stage that runs *outside* the
  front-end lock) — so host-side batching of micro-batch N+1 overlaps
  with the dispatch of micro-batch N, and submissions never wait on a
  dispatch.  The dispatcher is the one serving thread that launches work
  on the card (on PyTorch's current stream, without autograd).

Every submitted request terminates in exactly one of DONE (dispatch /
cache / coalesced), FAILED (engine kept raising past the retry cap), or
REJECTED (queue bound, expired deadline, or shutdown) — pinned under
injected faults by tests/test_torch_frontend.py and ``chip_smoke.py``.

Admission control: with ``ServeConfig.max_queue`` set, a full per-model
queue either rejects at the door (``admission="reject"``, REJECTED with a
retry-after hint — shed load instead of buffering it) or blocks the
submitter until space frees (``admission="block"`` — backpressure).
Deadlines (``timeout_s``) shed still-queued requests at batch formation.
Failure handling — jittered-exponential retry backoff and the degraded
sequential-route fallback — lives in the server layer and works identically
here; the dispatcher simply records failures and moves on instead of
re-raising.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import (Callable, Deque, Dict, Iterable, List, Optional, Tuple,
                    TYPE_CHECKING)

import numpy as np

from repro_torch.serve.batcher import MicroBatch
from repro_torch.serve.request import SOURCE_REJECTED, DSEResponse
from repro_torch.serve.server import DSEServer, _now

if TYPE_CHECKING:
    from repro_torch.dataset.generator import Dataset


@dataclasses.dataclass
class FrontendConfig:
    admission: str = "reject"    # full-queue policy: "reject" sheds at the
                                 # door, "block" backpressures the submitter
                                 # (only meaningful with ServeConfig.max_queue)
    default_timeout_s: Optional[float] = None  # per-request deadline applied
                                 # when submit() gets no explicit timeout_s
                                 # (None = no deadline)
    max_prepared: int = 2        # formed micro-batches buffered ahead of the
                                 # dispatcher — the batching/compute overlap
                                 # window (1 = form strictly one ahead)
    idle_sleep_s: float = 0.002  # former poll while queues are empty/backing
                                 # off (submit() wakes it immediately)
    latency_window: int = 4096   # submit->response samples kept for p50/p99


def _percentiles(samples: Iterable[float]) -> Dict[str, float]:
    if not samples:
        return {"n": 0, "p50_ms": float("nan"), "p99_ms": float("nan"),
                "mean_ms": float("nan"), "max_ms": float("nan")}
    a = np.asarray(samples, np.float64) * 1e3
    return {"n": int(a.size), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean()), "max_ms": float(a.max())}


class ServeFrontend:
    """Thread-pooled continuous-batching front end over one `DSEServer`.

    Use as a context manager (``with ServeFrontend(srv) as fe: ...``) or
    call ``start()``/``stop()`` explicitly.  One lock serializes every
    server-state mutation (submission, formation, publication); only the
    engine execution itself runs outside it.
    """

    def __init__(self, server: DSEServer,
                 cfg: Optional[FrontendConfig] = None):
        self.cfg = cfg or FrontendConfig()
        assert self.cfg.admission in ("reject", "block"), self.cfg.admission
        self.server = server
        self._lock = threading.RLock()
        self._space = threading.Condition(self._lock)   # queue-space waiters
        self._work = threading.Event()                  # submit -> former
        self._futures: Dict[int, Future] = {}
        self._meta: Dict[int, Tuple[str, float]] = {}   # rid -> (model, t0)
        # responses that land before submit() has registered the rid (cache
        # hits / door rejections resolve inside server.submit); bounded so
        # responses for rids never submitted through this front end (mixed
        # sync use) cannot accumulate
        self._early: "OrderedDict[int, DSEResponse]" = OrderedDict()
        self._latencies: Deque[float] = deque(
            maxlen=max(self.cfg.latency_window, 1))
        self._prepared: "queue.Queue[Optional[MicroBatch]]" = queue.Queue(
            maxsize=max(self.cfg.max_prepared, 1))
        self._running = False
        self._stopping = False
        self._threads: List[threading.Thread] = []
        # response observers (the online loop's hard-example harvest tap);
        # called under the front-end lock for every server response
        self._listeners: List[Callable[[DSEResponse], None]] = []
        self._listener_errors = 0
        self._last_listener_error: Optional[str] = None
        server.on_response = self._on_response

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> "ServeFrontend":
        with self._lock:
            if self._running:
                return self
            self._running, self._stopping = True, False
        self._threads = [
            threading.Thread(target=self._former_loop, name="dse-former",
                             daemon=True),
            threading.Thread(target=self._dispatch_loop,
                             name="dse-dispatcher", daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Stop the pipeline.  ``drain=True`` serves everything still
        queued first; ``drain=False`` rejects queued requests (REJECTED,
        "server shutting down") but still finishes already-formed batches.
        Either way every outstanding future resolves."""
        with self._lock:
            if not self._running:
                return
            self._stopping = True
            if not drain:
                self.server.reject_pending()
        self._work.set()
        for t in self._threads:
            t.join(timeout)
        with self._lock:
            self._running = False
            # defensive: no future may outlive the pipeline
            for rid, fut in list(self._futures.items()):
                model, _ = self._meta.get(rid, ("?", 0.0))
                self._resolve(fut, rid, DSEResponse(
                    rid, model, None, SOURCE_REJECTED,
                    error="front end stopped"))
            self._futures.clear()

    def __enter__(self) -> "ServeFrontend":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop(drain=True)

    # ---- submission --------------------------------------------------------
    def submit(self, model_name: str, net_idx: np.ndarray, lat_obj: float,
               pow_obj: float, seed: int = 0,
               timeout_s: Optional[float] = None) -> Future:
        """Non-blocking submit; returns a Future resolving to the request's
        `DSEResponse` (the future carries ``.rid``).  ``timeout_s`` sets
        the deadline (None = ``FrontendConfig.default_timeout_s``; pass
        ``float("inf")`` to force no deadline past a config default).
        With ``admission="block"`` and a full queue this call waits for
        space (backpressure); with ``admission="reject"`` it returns an
        already-resolved REJECTED future."""
        t = timeout_s if timeout_s is not None else self.cfg.default_timeout_s
        deadline = None if t is None or not math.isfinite(t) else _now() + t
        fut: Future = Future()
        with self._space:
            # checked under the lock: a lock-free read races stop(), which
            # flips _running while draining _futures
            if not self._running:
                raise RuntimeError("ServeFrontend not started (use start() "
                                   "or a with-block)")
            if self.cfg.admission == "block" and self.server.cfg.max_queue > 0:
                while (not self._stopping
                       and self.server.batcher.pending(model_name)
                       >= self.server.cfg.max_queue
                       and (deadline is None or _now() < deadline)):
                    self._space.wait(timeout=0.05)
            t0 = time.perf_counter()
            rid = self.server.submit(model_name, net_idx, lat_obj, pow_obj,
                                     seed=seed, deadline=deadline)
            early = self._early.pop(rid, None)
            if early is not None:           # cache hit / door rejection
                self._resolve(fut, rid, early, t0)
            else:
                self._futures[rid] = fut
                self._meta[rid] = (model_name, t0)
        self._work.set()
        fut.rid = rid  # type: ignore[attr-defined]
        return fut

    def submit_network(self, model_name: str, desc: Dict[str, float],
                       lat_obj: float, pow_obj: float, seed: int = 0,
                       timeout_s: Optional[float] = None) -> Future:
        from repro_torch.core.dse_api import parse_network
        net_idx = parse_network(desc, self.server.engines[model_name].model)
        return self.submit(model_name, net_idx, lat_obj, pow_obj, seed=seed,
                           timeout_s=timeout_s)

    # ---- params hot-swap ---------------------------------------------------
    def swap(self, model_name: str, ds: "Dataset", g_params: Dict) -> int:
        """Lock-disciplined hot swap: refresh a hosted engine's
        dataset/params (``DSEServer.swap`` -> ``GANDSE.attach``, no
        retrain) *under the front-end lock*, serialized against
        submission, batch formation, and publication; returns the number
        of invalidated cache entries.

        This is the only safe swap on a live front end: ``DSEServer.swap``
        mutates engine and cache state, so calling it directly races the
        former/dispatcher threads (repro-lint GL111 flags the pattern).
        A batch already executing when the swap lands is handled by the
        params-generation stamp — it still answers (with the old params,
        the documented in-flight semantics) but cannot re-poison the
        freshly invalidated cache."""
        with self._lock:
            return self.server.swap(model_name, ds, g_params)

    def add_response_listener(
            self, fn: Callable[[DSEResponse], None]) -> None:
        """Register an observer called for every server response (DONE,
        FAILED, and REJECTED alike) — the online loop's hard-example
        harvest tap.  Listeners run under the front-end lock, so they must
        be fast and non-blocking; a raising listener is counted
        (``metrics()["frontend"]["listener_errors"]``) and skipped rather
        than allowed to wedge the pipeline."""
        with self._lock:
            self._listeners.append(fn)

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has resolved (no queued
        work, no buffered batches, no outstanding futures); returns False
        on timeout."""
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                idle = (not self._futures
                        and self.server.batcher.pending() == 0
                        and self._prepared.empty())
            if idle:
                return True
            if end is not None and time.monotonic() >= end:
                return False
            time.sleep(0.005)

    # ---- pipeline threads --------------------------------------------------
    def _former_loop(self) -> None:
        srv = self.server
        while True:
            with self._space:
                batch = srv.form_batch()
                if batch is not None:
                    self._space.notify_all()   # queue space freed
            if batch is not None:
                # blocks when the overlap window is full — natural
                # backpressure from the dispatcher
                self._prepared.put(batch)
                continue
            pending = srv.batcher.pending()
            with self._lock:
                stopping = self._stopping
            if stopping and pending == 0:
                break
            if pending == 0:
                self._work.wait(timeout=0.05)
                self._work.clear()
            else:
                # everything with work is inside a retry-backoff window:
                # sleep toward the earliest expiry instead of spinning
                now = _now()
                waits = [srv._backoff_until.get(m, now) - now
                         for m in srv.batcher.models_with_work()]
                wait = min(waits) if waits else self.cfg.idle_sleep_s
                time.sleep(min(max(wait, self.cfg.idle_sleep_s), 0.05))
        self._prepared.put(None)               # dispatcher shutdown sentinel

    def _dispatch_loop(self) -> None:
        srv = self.server
        while True:
            batch = self._prepared.get()
            if batch is None:
                break
            try:
                # the overlap: engine compute runs with NO front-end lock,
                # so submissions and next-batch formation proceed under it
                results, info = srv.execute_batch(batch)
            except Exception as e:
                with self._space:
                    srv.fail_batch(batch, e)   # requeue/FAIL + arm backoff
                    self._space.notify_all()
                self._work.set()
                continue
            with self._space:
                srv.publish_batch(batch, results, info)
                self._space.notify_all()

    # ---- response plumbing -------------------------------------------------
    def _on_response(self, resp: DSEResponse) -> None:  # lint: disable=lock-discipline
        # called from DSEServer._respond — always under self._lock (every
        # server-state mutation happens inside it), so taking it again
        # here would only recurse on the RLock
        for listener in self._listeners:
            try:
                listener(resp)
            except Exception as e:
                # an observer must never take down the pipeline; the error
                # is recorded (not swallowed silently) for metrics()
                self._listener_errors += 1
                self._last_listener_error = repr(e)
        fut = self._futures.pop(resp.rid, None)
        if fut is None:
            self._early[resp.rid] = resp
            while len(self._early) > 1024:
                self._early.popitem(last=False)
            return
        self._resolve(fut, resp.rid, resp)

    def _resolve(self, fut: Future, rid: int, resp: DSEResponse,  # lint: disable=lock-discipline
                 t0: Optional[float] = None) -> None:
        # contract: only reached from submit() / _on_response(), both of
        # which already hold self._lock
        meta = self._meta.pop(rid, None)
        if t0 is None and meta is not None:
            t0 = meta[1]
        if t0 is not None:
            self._latencies.append(time.perf_counter() - t0)
        if not fut.done():
            fut.set_result(resp)

    # ---- introspection -----------------------------------------------------
    def metrics(self) -> Dict:
        """Health/metrics snapshot: the server summary (queue depths, shed
        and degraded counters, cache hit rate, backoff state) plus front
        -end submit->response latency percentiles and pipeline depth."""
        with self._lock:
            s = self.server.summary()
            s["frontend"] = {
                "running": self._running,
                "inflight": len(self._futures),
                "prepared_batches": self._prepared.qsize(),
                "admission": self.cfg.admission,
                "listeners": len(self._listeners),
                "listener_errors": self._listener_errors,
                "last_listener_error": self._last_listener_error,
                "latency": _percentiles(list(self._latencies)),
            }
            return s
