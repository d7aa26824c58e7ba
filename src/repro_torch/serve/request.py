"""Request/response records for the DSE serving subsystem.

One `DSERequest` is one user query from the paper's exploration phase: a
parsed network (net-space indices), the two objectives `metric <= x`, and
the noise seed that makes the query reproducible.  The server answers with
a `DSEResponse` wrapping the engine's `DSEResult` plus serving metadata
(which micro-batch carried it, whether it was a cache hit or coalesced
onto an identical in-flight request, whether the degraded host route
computed it).

Terminal states — every admitted request reaches exactly one:

- ``dispatch`` / ``cache`` / ``coalesced``: answered with a result;
- ``failed``: the engine kept raising past the retry cap (``error`` holds
  the last exception's message) — the work was attempted and lost;
- ``rejected``: admission control shed the request *before* dispatch
  (queue full, deadline expired, or server shutdown) — the work was never
  attempted, and ``retry_after`` hints when resubmission is likely to be
  admitted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.dse_api import DSEResult, cache_key
from repro_torch.dataset.generator import DSETask

#: how a response was produced
SOURCE_DISPATCH = "dispatch"     # computed by this micro-batch
SOURCE_CACHE = "cache"           # LRU hit from an earlier dispatch
SOURCE_COALESCED = "coalesced"   # rode an identical in-flight request
SOURCE_FAILED = "failed"         # dispatch kept failing; gave up (see error)
SOURCE_REJECTED = "rejected"     # shed before dispatch (queue bound, expired
                                 # deadline, or shutdown); see retry_after


@dataclasses.dataclass(frozen=True)
class DSERequest:
    """One admitted DSE query."""

    rid: int                     # server-assigned, unique per server
    model_name: str              # which registered engine serves it
    net_idx: np.ndarray          # (n_net_dims,) parsed network indices
    lat_obj: float               # latency objective, seconds
    pow_obj: float               # power objective, watts
    seed: int = 0                # per-request noise seed
    deadline: Optional[float] = None  # time.monotonic() expiry; expired
                                      # requests are shed at batch formation
                                      # (best effort: a request already in a
                                      # formed batch is served late instead)

    @property
    def key(self) -> Tuple:
        """Result-cache identity (see `repro_torch.core.dse_api.cache_key`).
        The deadline is serving metadata, not task identity: two requests
        for the same work coalesce regardless of their deadlines."""
        return cache_key(self.model_name, self.net_idx, self.lat_obj,
                         self.pow_obj, self.seed)

    def as_task(self) -> DSETask:
        """This request as a 1-row task batch."""
        return DSETask.single(self.net_idx, self.lat_obj, self.pow_obj)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


@dataclasses.dataclass
class DSEResponse:
    """The server's answer to one request.  ``result`` is None only for
    SOURCE_FAILED (the engine kept raising past the retry cap; ``error``
    carries the last exception's message) and SOURCE_REJECTED (admission
    control shed the request before dispatch; ``retry_after`` hints the
    resubmission delay in seconds) responses."""

    rid: int
    model_name: str
    result: Optional[DSEResult]
    source: str = SOURCE_DISPATCH
    batch_size: int = 1          # real (unpadded) rows in the carrying batch
    error: Optional[str] = None
    retry_after: Optional[float] = None  # REJECTED only: resubmit-after hint, s
    degraded: bool = False       # computed by the sequential fallback route
                                 # (the batched route was failing)
    # task identity of answered responses (None on FAILED/REJECTED): with
    # the result's own objectives these reconstruct the request's cache
    # key, which is how the online loop (`repro_torch.serve.online`) harvests
    # unsatisfied responses as deduplicated hard training examples
    net_idx: Optional[np.ndarray] = None
    seed: Optional[int] = None

    @property
    def cached(self) -> bool:
        return self.source == SOURCE_CACHE

    @property
    def rejected(self) -> bool:
        return self.source == SOURCE_REJECTED

    @property
    def ok(self) -> bool:
        return self.result is not None
