"""Batched LM serving: a continuous-batching loop over a request queue.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --requests 16 --max-new 32

Every ported arch serves: the dense decoders, the MoE ones (mixtral-8x7b,
phi3.5-moe), whose decode step routes its lanes together at the
reference's capacity for that many tokens (``nn/moe``), so an MoE model's
decode is not its prefill, in the reference as here, hymba-1.5b, whose
lanes carry an SSM state that a reused lane resets, and xlstm-1.3b,
whose lanes carry only recurrent states (the mLSTM's (C, n, m), the
sLSTM's (c, n, m, h)): no KV cache, so no horizon.  The params
come from ``models/base.init_params`` on ``prng_key(--seed)``: the
reference's initial weights for the same seed.

A minimal production-shaped server, as in the reference: requests (prompt
token lists) are admitted into a fixed set of batch slots; every engine
iteration runs one batched decode step; finished sequences free their
slot for the next queued request (continuous batching).  A prompt is fed
through the decode step one token at a time (for a dense decoder the
same math as a dedicated prefill pass; see above for MoE).  ``--reduced`` is a ``store_true`` flag that
defaults to True, as in the reference, so the CLI always serves the
REDUCED config; the full width is reached through ``Engine`` itself.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.explorer import resolve_device
from repro_torch.models import base as MB
from repro_torch.optim import tree_map
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _recurrent_template(states, m):
    """A copy of the recurrent (ssm / xLSTM) portion of a freshly
    initialized decode state, per segment/spec: hymba's (h, tail) stacks,
    an xLSTM layer's whole tuple, and None where a spec carries no
    recurrent state (the dense and MoE decoders).  KV caches are excluded: the per-lane `start` mask handles
    them."""
    def copy(tree):
        return None if tree is None else tree_map(torch.clone, tree)

    return [[copy(st.get("ssm")) if spec.kind in ("dense", "dec")
             else copy(st) for st, spec in zip(seg_st, seg.pattern)]
            for seg_st, seg in zip(states, m.segments)]


def _reset_recurrent_lane(states, fresh, m, lane: int) -> None:
    """Re-initialize lane `lane` of the per-lane recurrent decode state in
    place when its batch slot is reused for a new request, from the fresh
    copy (`_recurrent_template`).  State leaves are stacked (repeats,
    batch, ...), so a lane is axis 1.  A no-op for the dense and MoE
    models, whose KV caches need no copy: the per-lane `start` mask passed
    to the decode step hides a reused lane's stale entries (see
    `decode_attention`)."""
    def scatter(st, fr):
        tree_map(lambda a, f: a[:, lane].copy_(f[:, lane]), st, fr)

    for seg_st, seg_fr, seg in zip(states, fresh, m.segments):
        for st, fr, spec in zip(seg_st, seg_fr, seg.pattern):
            if spec.kind not in ("dense", "dec"):
                scatter(st, fr)
            elif fr is not None:
                scatter(st["ssm"], fr)


class Engine:
    """Fixed-slot continuous batching engine.

    Every decode step advances the shared clock by one: each layer's KV
    cache writes slot `clock`, and the RoPE position equals the clock, so
    positions stay monotonic for every stream and relative offsets within
    a stream are exact.  Reusing a slot for a new request records the
    admission clock in ``start[slot]``; the decode step masks cache
    entries before it (the previous occupant's), so a reused slot computes
    exactly what a fresh engine would.

    ``device=None`` means the card and raises where there is none; the
    params must lie on the engine's device.

    ``mesh`` with a 'model' axis larger than 1: every rank builds the
    engine from the same full params, which it shards
    (``shardings.shard_params``: each rank keeps its blocks, the caller
    may drop the full tree), and its decode states, sharded likewise
    (``shard_states``: a rank holds its block of the lanes where the
    batch axes split them, and resets only those).  Every rank runs the
    same schedule; the greedy
    token is the argmax of the gathered logits, which every rank holds
    whole, so every rank admits and retires the same requests.
    """

    def __init__(self, m, params, batch_slots: int, cache_len: int,
                 mesh=None, eos: Optional[int] = None, device=None):
        want = resolve_device(device)
        self.device = params["ln_f"]["scale"].device
        if self.device.type != want.type:
            raise ValueError(f"params are on {self.device}, the engine on "
                             f"{want}")
        self.m = m
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.cache_len = cache_len
        self.eos = eos
        self.states = MB.init_decode_state(params, m, batch_slots, cache_len)
        self._lanes = None
        if SH.model_axis(mesh) > 1:
            params = SH.shard_params(params, mesh)
            self.states = SH.shard_states(self.states, mesh, batch_slots)
            ax = TS._row_axis(mesh, batch_slots)
            n = batch_slots // ax.size
            self._lanes = range(ax.rank * n, (ax.rank + 1) * n)
        self.params = params
        self._fresh_recurrent = _recurrent_template(self.states, m)
        self.pos = np.zeros(batch_slots, np.int32)  # per-slot prompt cursor
        self.clock = 0                 # == every layer state's `len`
        # non-windowed attention writes KV at slot `clock`: once the clock
        # reaches the cache span the write has no slot — fail loudly.  A
        # windowed layer whose ring is narrower than its window (cache_len
        # < window) would drop in-window keys once it wraps, so it sets the
        # same horizon; rings as wide as the window have none.
        self._kv_horizon = cache_len if any(
            sp.kind in ("dense", "dec") and (sp.cfg.window is None
                                             or sp.cfg.window > cache_len)
            for seg in m.segments for sp in seg.pattern) else None
        self.start = np.zeros(batch_slots, np.int32)  # per-slot stream start
        self._decode = TS.make_decode_step(
            m, mesh=mesh, cache_len=cache_len if SH.model_axis(mesh) > 1
            else None)
        self.queue: List[Request] = []
        self.finished: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                self.pos[i] = 0
                # stale-state reset: mask the previous occupant's KV range
                # [0, clock) out of this lane's attention, and re-init its
                # recurrent cells
                self.start[i] = self.clock
                if self._lanes is None:
                    _reset_recurrent_lane(self.states, self._fresh_recurrent,
                                          self.m, i)
                elif i in self._lanes:          # this rank's block of lanes
                    _reset_recurrent_lane(self.states, self._fresh_recurrent,
                                          self.m, i - self._lanes.start)

    def step(self):
        """One engine iteration: every active slot advances one token."""
        self._admit()
        toks = np.zeros((len(self.slots), 1), np.int64)
        active = False
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            active = True
            cursor = int(self.pos[i])
            if cursor < len(req.prompt):
                toks[i, 0] = req.prompt[cursor]
            else:
                toks[i, 0] = req.out[-1] if req.out else req.prompt[-1]
        if not active:
            return False
        if self._kv_horizon is not None and self.clock >= self._kv_horizon:
            raise RuntimeError(
                f"KV capacity exhausted: engine clock {self.clock} reached "
                f"cache_len {self._kv_horizon} (global-attention caches are "
                f"append-only across the engine's whole lifetime); size "
                f"cache_len for total engine steps, not per-request length")
        # slots share one position per step: the engine clock.  A stream
        # admitted at clock t0 sees positions t0..t0+n — offset by t0 from a
        # fresh engine, which RoPE's relative encoding cancels.
        logits, self.states = self._decode(
            self.params, torch.from_numpy(toks).to(self.device), self.clock,
            self.states, start=torch.from_numpy(self.start).to(self.device))
        self.clock += 1
        nxt = logits[:, 0].argmax(-1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.pos[i] += 1
            if self.pos[i] >= len(req.prompt):       # generating
                tok = int(nxt[i])
                req.out.append(tok)
                if len(req.out) >= req.max_new or (self.eos is not None
                                                   and tok == self.eos):
                    req.done = True
                    self.finished.append(req)
                    self.slots[i] = None
        return True

    def run(self, max_iters: int = 10_000):
        it = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and it < max_iters:
            self.step()
            it += 1
        return it


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    m = configs.get_reduced(args.arch)
    params = MB.init_params(prng.prng_key(torch.tensor(args.seed)), m, device)
    eng = Engine(m, params, args.slots, args.cache_len, device=device)

    np_rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for r in range(args.requests):
        prompt = np_rng.integers(0, m.vocab, size=args.prompt_len).tolist()
        eng.submit(Request(rid=r, prompt=prompt, max_new=args.max_new))
    iters = eng.run()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in eng.finished)
    print(f"[serve] arch={m.name} requests={len(eng.finished)}/{args.requests} "
          f"engine_iters={iters} new_tokens={toks} "
          f"tok/s={toks/max(dt,1e-9):.1f}")
    assert len(eng.finished) == args.requests
    return 0


if __name__ == "__main__":
    sys.exit(main())
