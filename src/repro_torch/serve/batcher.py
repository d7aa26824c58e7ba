"""Micro-batch coalescing: many independent in-flight requests -> few
pow2-bucketed `DSETask` dispatches.

A micro-batch of m requests is padded to the next power of two by
repeating its last row (padding rows are computed and discarded — every
task lane is independent, so they cannot perturb real rows), so the
engine sees at most log2(max_batch) distinct batch sizes however ragged
the arrival pattern is (the same bucketing `GANDSE.explore_batch` applies
itself, ``core/shard.pad_tasks``).

Per-request seeds ride along as a (T,) array (`task_keys` array form), so
a request's Selection never depends on which micro-batch it landed in or
at which position.

Under an active task mesh the padded size is also a multiple of the
shard count — ``n_shards * pow2_bucket(ceil(m / n_shards))`` — so one
sharded dispatch serves the whole micro-batch with every rank's block full
(the count is ``shard.active_n_shards()``, read when a batch forms; 1
shard is the plain pow2 bucket).

Thread safety: every queue operation holds one internal lock, so the
concurrent front end can admit from submitter threads while the former
thread pops micro-batches — admit/next_batch/requeue/shed interleave
atomically and no request is ever lost or double-popped (pinned by
tests/test_torch_frontend.py).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import shard
from repro_torch.dataset.generator import DSETask
from repro_torch.serve.request import DSERequest


@dataclasses.dataclass
class MicroBatch:
    """One dispatchable unit: the real requests plus the padded task batch.

    ``tasks``/``seeds`` carry ``padded_size`` rows; only the first
    ``len(requests)`` are real, the rest repeat the last real row and are
    dropped after dispatch.
    """

    model_name: str
    requests: List[DSERequest]
    tasks: DSETask
    seeds: np.ndarray            # (padded_size,) int64 per-row noise seeds
    #: per-model params generation the batch was formed under (stamped by
    #: `DSEServer._pop_ready`).  `publish_batch` compares it against the
    #: live counter: a swap landing between the lock-free execute and the
    #: publish invalidated the model's cache entries, so a mismatched
    #: batch still responds but must not re-cache its (old-params) results.
    params_gen: int = 0

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def padded_size(self) -> int:
        return len(self.tasks)


class MicroBatcher:
    """Per-model FIFO admission queues + micro-batch formation."""

    def __init__(self, max_batch: int = 64, pad_pow2: bool = True):
        assert max_batch >= 1
        self.max_batch = int(max_batch)
        self.pad_pow2 = bool(pad_pow2)
        self._queues: "OrderedDict[str, Deque[DSERequest]]" = OrderedDict()
        self._lock = threading.RLock()

    def admit(self, req: DSERequest) -> None:
        with self._lock:
            self._queues.setdefault(req.model_name, deque()).append(req)

    def requeue_front(self, reqs: List[DSERequest]) -> None:
        """Push popped requests back to the head of their queue in their
        original order (dispatch-failure recovery: nothing is lost, the
        next step retries them)."""
        with self._lock:
            for req in reversed(reqs):
                self._queues.setdefault(req.model_name,
                                        deque()).appendleft(req)

    def pending(self, model_name: Optional[str] = None) -> int:
        with self._lock:
            if model_name is not None:
                return len(self._queues.get(model_name, ()))
            return sum(len(q) for q in self._queues.values())

    def models_with_work(self) -> List[str]:
        with self._lock:
            return [m for m, q in self._queues.items() if q]

    def shed(self, predicate: Callable[[DSERequest], bool]
             ) -> List[DSERequest]:
        """Remove (and return) every queued request matching ``predicate``,
        preserving FIFO order among survivors and pruning drained queues.
        The admission-control hook: the server sheds expired-deadline
        requests here, *before* they can occupy a dispatch slot."""
        with self._lock:
            out: List[DSERequest] = []
            for name in list(self._queues):
                q = self._queues[name]
                kept = deque()
                for req in q:
                    (out if predicate(req) else kept).append(req)
                if kept:
                    self._queues[name] = kept
                else:
                    del self._queues[name]
            return out

    def next_batch(self, model_name: Optional[str] = None,
                   rotate: Optional[bool] = None) -> Optional[MicroBatch]:
        """Pop up to ``max_batch`` queued requests (FIFO; round-robin over
        models when ``model_name`` is None) and coalesce them into one
        padded micro-batch.  Returns None when nothing is queued.

        A queue drained by the pop is pruned from the table (the dict used
        to grow one dead entry per retired model under model churn), and
        the round-robin order rotates only on round-robin pops (``rotate``
        defaults to exactly that) — a targeted ``next_batch(model_name=…)``
        does not steal the models behind the target their turn.  The
        server's backoff-aware formation passes an explicit model *and*
        ``rotate=True``: it pre-selects the round-robin head itself (to
        skip models in a retry-backoff window) and the rotation must still
        happen.
        """
        with self._lock:
            round_robin = model_name is None
            if round_robin:
                work = self.models_with_work()
                if not work:
                    return None
                model_name = work[0]
            if rotate is None:
                rotate = round_robin
            q = self._queues.get(model_name)
            if not q:
                return None
            reqs = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
            if not q:
                del self._queues[model_name]
            elif rotate:
                # rotate to the back so multi-model queues share dispatches
                self._queues.move_to_end(model_name)

        m = len(reqs)
        tasks = DSETask.concat([r.as_task() for r in reqs])
        seeds = np.array([r.seed for r in reqs], np.int64)
        k = shard.active_n_shards()
        per_shard = -(-m // k)       # ceil(m / k)
        if self.pad_pow2:
            per_shard = shard.pow2_bucket(per_shard, floor=1)
        rows = shard.pad_rows(m, per_shard * k)
        if rows is not None:
            tasks = tasks.take(rows)
            seeds = seeds[rows]
        return MicroBatch(model_name=model_name, requests=reqs,
                          tasks=tasks, seeds=seeds)
