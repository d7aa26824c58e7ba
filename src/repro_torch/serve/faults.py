"""Fault injection for the serving stack: deterministic chaos for the
fault runs of the tests and ``chip_smoke.py``.

`FaultyEngine` wraps any `DSEMethod` engine and injects, per dispatch:

- **exceptions** (`InjectedFault`): a deterministic burst window
  (``burst_start``/``burst_len``, counted in batched-route dispatches)
  plus an optional seeded random rate — with ``device_route_only=True``
  (default) the sequential route (``batched=False``) is immune, so the
  server's degraded-route fallback genuinely recovers;
- **latency spikes**: seeded-random ``time.sleep`` stalls, exercising
  deadline shedding and queue backpressure without breaking correctness;
- the wrapper is otherwise transparent (explore/train/attach/set_use_fused
  pass through; it reports the engine's device and gan_cfg), so
  Selections are identical to the bare engine whenever a dispatch
  survives — the fault runs pin their responses against standalone
  ``explore_tasks`` results.

`corrupt_checkpoint` flips bytes inside a saved checkpoint's payload so
`CheckpointManager.restore`/`verify` must raise
`CheckpointCorruptionError` — the corrupted-params-on-swap scenario: a
fault-injected retrain loop saves params, the file is damaged, and the
serving tier must detect it at swap time and keep the last good params
instead of attaching garbage.
"""
from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Optional

from repro_torch.core.dse_api import DSEMethod


class InjectedFault(RuntimeError):
    """An exception injected by a `FaultPlan` (never a real engine error)."""


@dataclasses.dataclass
class FaultPlan:
    """What to inject.  All randomness is seeded: two runs of the same plan
    against the same traffic inject identically."""

    seed: int = 0
    #: deterministic failure window: device-route dispatches with index in
    #: [burst_start, burst_start + burst_len) raise InjectedFault (indices
    #: count only fault-eligible dispatches, so the window is route-stable)
    burst_start: int = 0
    burst_len: int = 0
    #: additional seeded-random failures, P(raise) per eligible dispatch
    error_rate: float = 0.0
    #: stop injecting errors after this many total (None = unlimited) —
    #: guarantees a finite fault window so recovery can be asserted
    max_errors: Optional[int] = None
    #: inject errors only on the batched route; the sequential fallback
    #: stays healthy — models the common real failure (an out-of-memory
    #: or a failed launch at the batch's size) where the per-task path
    #: survives
    device_route_only: bool = True
    #: seeded-random latency spikes: P(spike) per dispatch, spike duration
    spike_rate: float = 0.0
    spike_s: float = 0.02


class FaultyEngine:
    """`DSEMethod` wrapper that executes a `FaultPlan` at dispatch time."""

    def __init__(self, engine: DSEMethod, plan: FaultPlan):
        self._inner = engine
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self.model = engine.model
        self.method_name = getattr(engine, "method_name", "faulty")
        self.injected_errors = 0
        self.injected_spikes = 0
        self.dispatches = 0          # all explore_tasks calls
        self.eligible_dispatches = 0  # calls the plan could fail

    # the serving layer reads gan_cfg/device for its kernel-route report
    @property
    def gan_cfg(self):
        return getattr(self._inner, "gan_cfg", None)

    @property
    def device(self):
        return getattr(self._inner, "device", None)

    def set_use_fused(self, use_fused):
        setter = getattr(self._inner, "set_use_fused", None)
        if setter is not None:
            setter(use_fused)
        return self

    def train(self, *a, **kw):
        return self._inner.train(*a, **kw)

    def attach(self, ds, g_params):
        return self._inner.attach(ds, g_params)

    def explore(self, net_idx, lat_obj, pow_obj, seed: int = 0):
        return self._inner.explore(net_idx, lat_obj, pow_obj, seed=seed)

    def _maybe_fail(self, device_route: bool) -> None:
        p = self.plan
        if p.device_route_only and not device_route:
            return
        i = self.eligible_dispatches
        self.eligible_dispatches += 1
        if p.max_errors is not None and self.injected_errors >= p.max_errors:
            return
        in_burst = p.burst_len > 0 and \
            p.burst_start <= i < p.burst_start + p.burst_len
        if in_burst or (p.error_rate > 0
                        and self._rng.random() < p.error_rate):
            self.injected_errors += 1
            raise InjectedFault(
                f"injected dispatch fault #{self.injected_errors} "
                f"(eligible dispatch {i})")

    def explore_tasks(self, tasks, seed=0, batched=None):
        self.dispatches += 1
        p = self.plan
        if p.spike_rate > 0 and self._rng.random() < p.spike_rate:
            self.injected_spikes += 1
            time.sleep(p.spike_s)
        # batched=False is the sequential route; None/True take the batched
        # route whenever the model supports it (the server's degraded
        # fallback passes False explicitly)
        self._maybe_fail(device_route=batched is not False)
        return self._inner.explore_tasks(tasks, seed=seed, batched=batched)

    def fault_stats(self) -> dict:
        return {"dispatches": self.dispatches,
                "eligible_dispatches": self.eligible_dispatches,
                "injected_errors": self.injected_errors,
                "injected_spikes": self.injected_spikes}


def corrupt_checkpoint(step_dir: str, seed: int = 0, n_bytes: int = 8,
                       host_index: int = 0) -> str:
    """Flip ``n_bytes`` random payload bytes of a saved checkpoint step (in
    the host npz, past the zip header so the file still opens) and return
    the damaged path.  `CheckpointManager.verify`/`restore` must raise
    `CheckpointCorruptionError` on it."""
    path = os.path.join(step_dir, f"host_{host_index}.npz")
    rng = random.Random(seed)
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        assert size > 256, f"checkpoint payload too small to corrupt: {size}"
        for _ in range(n_bytes):
            pos = rng.randrange(128, size - 64)
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))
    return path
