"""LRU result cache for served DSE queries.

Keyed on ``(model, net_idx, lat_obj, pow_obj, seed)`` — exactly the inputs
that determine a Selection under the batched-vs-sequential parity contract
(per-task noise keys depend only on the request's own seed, never on batch
placement), so a hit is indistinguishable from a recompute.  A hot-swap of
an engine's params (`DSEServer.swap`) invalidates that model's entries:
the key does not carry a params version, the swap does.

Thread safety: every operation holds one internal lock, so the concurrent
front end (`repro_torch.serve.frontend`) can hit the cache from submitter
threads while the dispatcher publishes — get/put/invalidate interleave
atomically and the LRU order, stat counters, and capacity bound stay
consistent (pinned by tests/test_torch_frontend.py).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from repro_torch.core.dse_api import DSEResult


class ResultCache:
    """Bounded LRU: get/put are O(1); capacity <= 0 disables caching."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._d: "OrderedDict[Tuple, DSEResult]" = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # model -> invalidation generation: how many times this model's
        # entries were dropped (one bump per params swap/re-register) —
        # the observable the online-loop smoke pins a hot swap by
        self.invalidations: Dict[str, int] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def get(self, key: Tuple) -> Optional[DSEResult]:
        if self.capacity <= 0:
            return None
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return hit

    def put(self, key: Tuple, result: DSEResult) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._d[key] = result
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self.evictions += 1

    def invalidate_model(self, model_name: str) -> int:
        """Drop every entry of one model (key[0] is the model name); returns
        how many were dropped.  Called on params hot-swap."""
        with self._lock:
            stale = [k for k in self._d if k[0] == model_name]
            for k in stale:
                del self._d[k]
            self.invalidations[model_name] = \
                self.invalidations.get(model_name, 0) + 1
            return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._d), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "invalidations": dict(self.invalidations)}
