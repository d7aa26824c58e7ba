"""Train-while-serve: the online improvement loop with checkpointed hot-swap.

The paper's negative-sample insight (§6.2: unsatisfied designs are the
informative training signal) extends naturally to serving: every request
the current generator fails to satisfy is a *hard example* the next
training generation should learn from.  This module closes that loop
around a live `ServeFrontend`:

    harvest -> mine -> train -> checkpoint -> swap -> invalidate

- **harvest**: a response listener (`ServeFrontend.add_response_listener`)
  feeds every unsatisfied served request into a bounded `HardTaskBuffer`,
  deduplicated by the request's cache key — the same identity the result
  cache uses, so one hard task is harvested once no matter how often it
  is re-asked;
- **mine**: `mine_hard_examples` turns each hard task into valid
  Algorithm 1 training rows (dataset rows double as (objective, witness)
  pairs — a row's own (L, P) are the objectives it satisfies), by
  sampling configs for the task's network and keeping the least-violating
  feasible ones;
- **train**: the mined rows round-robin into a fixed-size `HardReplay`
  region appended to the base dataset, and `train_gan` runs a few
  incremental epochs on the engine's device (the dense kernels on the
  card), warm-started from the previous generation's `TrainState`
  (params, optimizer moments, rng all resume).  The replay region is
  fixed-size, as the reference keeps it: every generation trains on the
  same shapes;
- **checkpoint**: each generation is saved through `CheckpointManager`
  (atomic publish, per-leaf checksums, `keep_last_n` retention; card
  tensors copied to the host) before it is ever served;
- **swap**: the new params are read *back from disk* (`restore_latest`,
  onto the trainer's device) and attached via the lock-disciplined
  `ServeFrontend.swap` — so the
  params being served are, by construction, exactly the params a crash
  restart would recover, and a corrupted save is detected at swap time
  (`CheckpointCorruptionError` inside `restore_latest` skips it) and the
  loop falls back to the previous good generation instead of attaching
  garbage;
- **invalidate**: the swap bumps the model's params generation and drops
  its cache entries (`DSEServer.swap`); a batch executing across the
  swap still answers but cannot re-poison the cache (the stale-stamp
  contract, `MicroBatch.params_gen`).

The trainer runs on one background thread; all its mutable state
(`TrainState`, generation counter, metrics) is touched by that thread
only.  The harvest listener runs on serving threads and touches only the
internally-locked `HardTaskBuffer`, which is the single point of
cross-thread handoff.  On the card the trainer and the front end's
dispatcher launch on PyTorch's one current stream, so their kernels run
in turn, never side by side; the swap hands over params the trainer's
read-back has already synchronized.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.dse_api import cache_key
from repro_torch.core.train import TrainState, train_gan
from repro_torch.dataset.generator import Dataset, DSETask
from repro_torch.serve.frontend import ServeFrontend
from repro_torch.serve.request import DSEResponse


@dataclasses.dataclass
class OnlineConfig:
    """Knobs for the online improvement loop."""

    buffer_capacity: int = 512   # hard-task buffer bound (oldest evicted)
    min_hard: int = 16           # buffered hard tasks that trigger a generation
    train_iters: int = 4         # incremental epochs per generation
    mine_samples: int = 256      # configs sampled per hard task when mining
    mine_per_task: int = 4       # best (least-violating) rows kept per task
    replay_capacity: int = 64    # fixed-size hard-example region appended to
                                 # the base dataset (fixed so data shapes
                                 # never change)
    keep_last_n: int = 3         # checkpoint retention (CheckpointManager)
    poll_s: float = 0.02         # trainer idle poll while below min_hard
    train_when_idle: bool = True  # defer a ready generation while requests
                                  # are in flight: the trainer competes
                                  # with dispatch for the host's cores and
                                  # the card's one stream, so training in
                                  # serving gaps is what keeps p99 flat
    idle_defer_s: float = 2.0    # starvation bound on that deferral: under
                                 # continuous load, train anyway after this
    canary_after_swap: bool = True  # after each swap, push one canary
                                 # request through the front end: the first
                                 # post-swap dispatch pays for the fresh
                                 # explorer, and eating it here keeps it
                                 # out of user-visible p99
    seed: int = 0                # replay init + per-generation train seeds
    max_generations: int = 0     # stop training after N generations (0 = no
                                 # cap; serving continues either way)
    #: fault-injection hook called with the just-saved step dir, after the
    #: checkpoint write and *before* the swap reads it back -- the soak
    #: harness points `repro_torch.serve.faults.corrupt_checkpoint` at it to
    #: prove a torn/corrupted save falls back to the previous generation
    post_checkpoint: Optional[Callable[[str], None]] = None


class HardTaskBuffer:
    """Bounded, deduplicating buffer of hard (unsatisfied) served tasks.

    Thread-safe: offered from serving threads (the response listener),
    drained by the trainer.  Keys on the request's cache key
    (`repro_torch.core.dse_api.cache_key`), so resubmissions of the same task
    are harvested once; at capacity the oldest entry is evicted (newer
    traffic is a better sample of what the current params fail on).
    """

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._d: "OrderedDict[Tuple, Tuple[np.ndarray, float, float]]" = \
            OrderedDict()
        self.offered = 0
        self.admitted = 0
        self.deduped = 0
        self.evicted = 0
        self.drained = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def offer(self, resp: DSEResponse) -> bool:
        """Harvest one response; returns True when it was admitted.  Only
        answered-but-unsatisfied responses with task identity qualify
        (FAILED/REJECTED responses carry no result to judge)."""
        with self._lock:
            self.offered += 1
            if (not resp.ok or resp.net_idx is None or resp.seed is None
                    or resp.result.satisfied):
                return False
            key = cache_key(resp.model_name, resp.net_idx,
                            resp.result.lat_obj, resp.result.pow_obj,
                            resp.seed)
            if key in self._d:
                self.deduped += 1
                return False
            self._d[key] = (np.array(resp.net_idx, np.int64, copy=True),
                            float(resp.result.lat_obj),
                            float(resp.result.pow_obj))
            self.admitted += 1
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self.evicted += 1
            return True

    def take_all(self) -> Optional[DSETask]:
        """Drain the buffer into one task batch (None when empty)."""
        with self._lock:
            items = list(self._d.values())
            self._d.clear()
            self.drained += len(items)
        if not items:
            return None
        return DSETask(
            net_idx=np.stack([net for net, _, _ in items]),
            lat_obj=np.asarray([lo for _, lo, _ in items], np.float64),
            pow_obj=np.asarray([po for _, _, po in items], np.float64),
        )

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._d), "capacity": self.capacity,
                    "offered": self.offered, "admitted": self.admitted,
                    "deduped": self.deduped, "evicted": self.evicted,
                    "drained": self.drained}


def _relative_violation(lat: np.ndarray, pw: np.ndarray,
                        lat_obj: float, pow_obj: float) -> np.ndarray:
    """Summed relative objective violation (0 = satisfied); non-finite
    metrics (a design the model cannot realize) score +inf, never 0 --
    the core/selector.py:is_satisfied convention."""
    finite = np.isfinite(lat) & np.isfinite(pw)
    v = (np.maximum(np.where(finite, lat, 0.0) / lat_obj - 1.0, 0.0)
         + np.maximum(np.where(finite, pw, 0.0) / pow_obj - 1.0, 0.0))
    return np.where(finite, v, np.inf)


def mine_hard_examples(model, tasks: DSETask, n_samples: int = 256,
                       per_task: int = 4,
                       rng: Optional[np.random.Generator] = None
                       ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]]:
    """Turn hard tasks into Algorithm 1 training rows.

    For each task, sample ``n_samples`` configs for its network, evaluate
    the design model, and keep the ``per_task`` *least-violating* finite
    rows near the objective frontier.  Every kept row is a valid training
    sample as-is -- in Algorithm 1 a row's own (L, P) are the objectives
    it satisfies exactly -- so the generator is taught witnesses in
    precisely the region it is currently failing to serve.

    Returns ``(net_idx, cfg_idx, latency, power)`` arrays, or None when
    nothing finite was mined (a task whose network admits no finite
    design contributes nothing).
    """
    rng = np.random.default_rng(0) if rng is None else rng
    nets: List[np.ndarray] = []
    cfgs: List[np.ndarray] = []
    lats: List[np.ndarray] = []
    pows: List[np.ndarray] = []
    for i in range(len(tasks)):
        net = np.asarray(tasks.net_idx[i]).reshape(1, -1)
        cfg_idx = model.space.sample_indices(rng, n_samples)
        net_rep = np.repeat(net, n_samples, axis=0)
        lat, pw = model.evaluate_indices(net_rep, cfg_idx)
        viol = _relative_violation(np.asarray(lat, np.float64),
                                   np.asarray(pw, np.float64),
                                   float(tasks.lat_obj[i]),
                                   float(tasks.pow_obj[i]))
        order = np.argsort(viol, kind="stable")[:per_task]
        keep = order[np.isfinite(viol[order])]
        if keep.size == 0:
            continue
        nets.append(net_rep[keep])
        cfgs.append(cfg_idx[keep])
        lats.append(np.asarray(lat)[keep])
        pows.append(np.asarray(pw)[keep])
    if not nets:
        return None
    return (np.concatenate(nets), np.concatenate(cfgs),
            np.concatenate(lats), np.concatenate(pows))


class HardReplay:
    """Fixed-size hard-example region appended to the base dataset.

    Initialized with random base rows (so generation 1 already trains on
    full-shape data) and overwritten round-robin as mined rows arrive.
    ``dataset()`` keeps the base normalizers -- the encoding contract the
    attached explorer was built against -- and always returns arrays of
    size ``base.n + capacity``: every generation trains on one shape.

    Single-threaded by design: only the trainer thread touches it.
    """

    def __init__(self, base: Dataset, capacity: int = 64, seed: int = 0):
        assert base.n > 0, "empty base dataset"
        self.base = base
        self.capacity = int(capacity)
        rng = np.random.default_rng(seed)
        pick = rng.integers(0, base.n, size=self.capacity)
        self._net = base.net_idx[pick].copy()
        self._cfg = base.cfg_idx[pick].copy()
        self._lat = base.latency[pick].copy()
        self._pow = base.power[pick].copy()
        self._cursor = 0
        self.absorbed = 0

    def mix_in(self, net_idx: np.ndarray, cfg_idx: np.ndarray,
               lat: np.ndarray, pw: np.ndarray) -> int:
        """Write mined rows round-robin into the replay region; returns
        how many were written (past one capacity's worth, newer rows
        overwrite older ones from the same call)."""
        n = int(np.asarray(lat).shape[0])
        for j in range(n):
            i = self._cursor % self.capacity
            self._net[i] = net_idx[j]
            self._cfg[i] = cfg_idx[j]
            self._lat[i] = lat[j]
            self._pow[i] = pw[j]
            self._cursor += 1
        self.absorbed += n
        return n

    def dataset(self) -> Dataset:
        """Base ∪ replay as one Dataset (base normalizers preserved)."""
        return dataclasses.replace(
            self.base,
            net_idx=np.concatenate([self.base.net_idx, self._net]),
            cfg_idx=np.concatenate([self.base.cfg_idx, self._cfg]),
            latency=np.concatenate([self.base.latency, self._lat]),
            power=np.concatenate([self.base.power, self._pow]),
        )


class OnlineLoop:
    """The train-while-serve loop around one hosted model.

    Wire-up: registers a harvest listener on the front end; ``start()``
    writes a generation-0 checkpoint of the currently-attached params
    (so `restore_latest` always has a pre-training fallback) and spawns
    the trainer thread.  Each generation: drain the hard buffer, mine
    training rows, fine-tune warm-started from the previous generation,
    checkpoint, then swap the *restored-from-disk* params in through the
    lock-disciplined `ServeFrontend.swap`.  A corrupted save (injected or
    real) is caught by the restore's checksum validation and serving
    falls back to the previous good generation -- the loop never attaches
    params it could not recover after a crash.

    Use as a context manager, or call ``start()``/``stop()``;
    ``run_generation()`` is callable synchronously (no thread) for tests.
    """

    def __init__(self, frontend: ServeFrontend, model_name: str,
                 checkpoint_dir: str, gan_cfg=None,
                 cfg: Optional[OnlineConfig] = None,
                 base_ds: Optional[Dataset] = None):
        self.cfg = cfg or OnlineConfig()
        self.frontend = frontend
        self.model_name = model_name
        self.engine = frontend.server.engines[model_name]
        self.model = self.engine.model
        self.gan_cfg = gan_cfg if gan_cfg is not None \
            else getattr(self.engine, "gan_cfg", None)
        assert self.gan_cfg is not None, \
            "engine has no gan_cfg; pass gan_cfg= explicitly"
        base = base_ds if base_ds is not None \
            else getattr(self.engine, "ds", None)
        assert base is not None, \
            "engine has no attached dataset; pass base_ds= explicitly"
        self.buffer = HardTaskBuffer(self.cfg.buffer_capacity)
        self.replay = HardReplay(base, capacity=self.cfg.replay_capacity,
                                 seed=self.cfg.seed)
        self.ckpt = CheckpointManager(checkpoint_dir,
                                      keep_last_n=self.cfg.keep_last_n)
        # warm-start source: a train()-ed engine hands over its TrainState
        # (params + optimizer moments resume); an attach()-ed engine has
        # none, so generation 1 initializes fresh inside train_gan.  The
        # trainer runs on the engine's device (the CPU only when named)
        self._state: Optional[TrainState] = getattr(self.engine, "state",
                                                    None)
        self.device = getattr(self.engine, "device", None)
        self.generation = 0          # generations trained by this loop
        self.serving_step = None     # checkpoint step currently attached
        self._rng = np.random.default_rng(self.cfg.seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._training = False       # trainer mid-generation (flag only:
                                     # written by the trainer thread, read
                                     # by pacing loops like the launcher's
                                     # between-wave catch-up wait)
        self._last_error: Optional[str] = None
        self.counters = {"generations": 0, "swaps": 0, "swap_fallbacks": 0,
                         "generation_errors": 0, "mined_rows": 0,
                         "harvested_batches": 0, "idle_defers": 0,
                         "canaries": 0}
        #: per generation: its training steps and seconds, the seconds of
        #: its checkpoint save and of the swap's read-back (restore_s), the
        #: payload's bytes, and the step the swap attached (serving_step);
        #: newest last
        self.timings: List[Dict[str, float]] = []
        frontend.add_response_listener(self._harvest)

    # ---- harvest (serving threads) -----------------------------------------
    def _harvest(self, resp: DSEResponse) -> None:
        # runs under the front-end lock: the buffer's own lock is a leaf
        # (never held while taking another), so this cannot deadlock
        if resp.model_name == self.model_name:
            self.buffer.offer(resp)

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> "OnlineLoop":
        if self._thread is not None:
            return self
        # generation 0: checkpoint the params being served *before* any
        # training, so restore_latest always has a fallback even if every
        # later save is damaged (skipped when resuming an existing dir)
        params = getattr(self.engine, "g_params", None)
        if params is not None and self.ckpt.latest_step() is None:
            self.ckpt.save(0, params, extra={"generation": 0})
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="dse-online-trainer",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 120.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self) -> "OnlineLoop":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    def _run(self) -> None:
        ready_since: Optional[float] = None
        while not self._stop.is_set():
            capped = (self.cfg.max_generations > 0
                      and self.generation >= self.cfg.max_generations)
            if not capped and len(self.buffer) >= self.cfg.min_hard:
                if ready_since is None:
                    ready_since = time.monotonic()
                if (self.cfg.train_when_idle
                        and not self.frontend.wait_all(timeout=0.0)
                        and (time.monotonic() - ready_since
                             < self.cfg.idle_defer_s)):
                    # requests in flight: yield the cores to serving and
                    # train in the gap (bounded, so continuous load cannot
                    # starve the trainer forever)
                    self.counters["idle_defers"] += 1
                    self._stop.wait(self.cfg.poll_s)
                    continue
                ready_since = None
                self._training = True
                try:
                    self.run_generation()
                except Exception as e:
                    # the trainer must never die silently mid-soak: count
                    # it, keep serving on the last good generation
                    self.counters["generation_errors"] += 1
                    self._last_error = repr(e)
                finally:
                    self._training = False
            else:
                self._stop.wait(self.cfg.poll_s)

    # ---- the generation step (trainer thread) ------------------------------
    def warmup(self) -> None:
        """Warm the training path before timed serving: one throwaway
        epoch on the replay dataset (fresh init, state discarded) at the
        shapes the real generations reuse — on the card it builds the
        dense kernels and fills the allocator's pool."""
        train_gan(self.model, self.replay.dataset(), self.gan_cfg,
                  iters=1, seed=self.cfg.seed, device=self.device)

    def run_generation(self) -> bool:
        """One harvest -> mine -> train -> checkpoint -> swap cycle;
        returns True when a generation was trained (False: nothing
        buffered and nothing mined -- no-op)."""
        tasks = self.buffer.take_all()
        if tasks is not None:
            self.counters["harvested_batches"] += 1
            mined = mine_hard_examples(self.model, tasks,
                                       n_samples=self.cfg.mine_samples,
                                       per_task=self.cfg.mine_per_task,
                                       rng=self._rng)
            if mined is not None:
                self.counters["mined_rows"] += self.replay.mix_in(*mined)
        elif self.generation > 0:
            return False        # nothing new to learn from
        t0 = time.perf_counter()
        self._state = train_gan(self.model, self.replay.dataset(),
                                self.gan_cfg, iters=self.cfg.train_iters,
                                seed=int(self._rng.integers(1 << 31)),
                                state=self._state, device=self.device)
        t1 = time.perf_counter()
        self.generation += 1
        self.counters["generations"] += 1
        sdir = self.ckpt.save(self.generation, self._state.g_params,
                              extra={"generation": self.generation,
                                     "mined_rows": self.counters["mined_rows"]})
        self.timings.append({
            "generation": self.generation, "train_s": t1 - t0,
            "steps": len(self._state.history),
            "save_s": time.perf_counter() - t1,
            "bytes": os.path.getsize(self.ckpt._payload(self.generation))})
        if self.cfg.post_checkpoint is not None:
            self.cfg.post_checkpoint(sdir)
        self._swap()
        return True

    def _swap(self) -> None:
        """Attach the newest *recoverable* checkpoint: the params are read
        back from disk, so what is served is exactly what a crash restart
        would restore, and a damaged save is detected (checksums) and
        skipped in favor of the previous good generation."""
        t0 = time.perf_counter()
        restored = self.ckpt.restore_latest(like=self._state.g_params)
        if self.timings:
            self.timings[-1]["restore_s"] = time.perf_counter() - t0
        if restored is None:
            self.counters["swap_fallbacks"] += 1
            self._last_error = "no restorable checkpoint; serving unchanged"
            return
        step, params = restored
        if self.timings:
            self.timings[-1]["serving_step"] = step
        if step != self.generation:
            # the just-saved step did not restore (corrupted/torn): an
            # older generation serves instead
            self.counters["swap_fallbacks"] += 1
        self.frontend.swap(self.model_name, self.replay.dataset(), params)
        self.serving_step = step
        self.counters["swaps"] += 1
        if self.cfg.canary_after_swap:
            self._canary()

    def _canary(self) -> None:
        """Pre-warm the freshly attached params through the real serving
        path (a base-dataset row satisfied by construction, under a seed
        no user request uses, so it neither hits the cache nor harvests
        itself as a hard task)."""
        base = self.replay.base
        seed = 2_000_000_000 - self.counters["swaps"]
        try:
            fut = self.frontend.submit(self.model_name, base.net_idx[0],
                                       float(base.latency[0]),
                                       float(base.power[0]), seed=seed)
            fut.result(timeout=30.0)
            self.counters["canaries"] += 1
        except (RuntimeError, FuturesTimeout):
            pass    # front end not running / saturated: strictly best-effort

    # ---- introspection -----------------------------------------------------
    @property
    def training(self) -> bool:
        """True while the trainer thread is mid-generation: pacing loops
        (the launcher's between-wave catch-up) wait on
        this so timed serving windows do not overlap a training burst."""
        return self._training

    def metrics(self) -> Dict:
        return {
            "generation": self.generation,
            "training": self._training,
            "serving_step": self.serving_step,
            "last_error": self._last_error,
            "buffer": self.buffer.stats(),
            "replay": {"capacity": self.replay.capacity,
                       "absorbed": self.replay.absorbed},
            "checkpoint_steps": self.ckpt.steps(),
            **self.counters,
        }
