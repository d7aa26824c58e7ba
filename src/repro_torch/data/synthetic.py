"""Deterministic synthetic LM data pipeline (numpy only; the same tokens
and labels as the reference package's ``data/synthetic.py``, bit for bit).

Tokens are a pure function of (seed, step, global row index) via a
counter-based hash, so:
  * every data-parallel shard generates exactly its own rows (shard i of
    n — no host-side data redistribution);
  * a restarted job replays the same batches from the checkpointed step
    (``launch/train``'s restart is tested in tests/test_torch_lm_train.py).

The stream mimics a Zipf-ish unigram LM plus a deterministic "copy motif"
so cross-entropy decreases visibly during the example runs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """xorshift-multiply counter hash (vectorized, uint32)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)
    x = (x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)
    x = x ^ (x >> np.uint64(16))
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_s: float = 1.2
    motif_period: int = 16


class SyntheticStream:
    """batch(step, shard_index, n_shards) -> (tokens, labels) numpy arrays
    of the shard's rows for that step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_s)
        self._cdf = np.cumsum(probs / probs.sum())

    def _tokens(self, step: int, rows: np.ndarray) -> np.ndarray:
        c = self.cfg
        # counter = seed * P1 + step * P2 + row * L + pos
        pos = np.arange(c.seq_len + 1, dtype=np.uint64)[None, :]
        ctr = (np.uint64(c.seed) * np.uint64(0x9E3779B1)
               + np.uint64(step) * np.uint64(0x85EBCA77)
               + rows.astype(np.uint64)[:, None] * np.uint64(c.seq_len + 1)
               + pos)
        u = _hash_u32(ctr).astype(np.float64) / 2**32
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.minimum(toks, c.vocab - 1)
        # deterministic copy motif: position p copies p - period when the
        # row-hash says so (gives the model something learnable)
        copy_mask = (_hash_u32(ctr + np.uint64(0xABCD)) & 3) == 0
        p = c.motif_period
        out = toks.copy()
        for start in range(p, c.seq_len + 1, p):
            seg = slice(start, min(start + p, c.seq_len + 1))
            src = slice(start - p, start - p + (seg.stop - seg.start))
            out[:, seg] = np.where(copy_mask[:, seg], out[:, src], toks[:, seg])
        return out

    def batch(self, step: int, shard_index: int = 0, n_shards: int = 1
              ) -> Tuple[np.ndarray, np.ndarray]:
        c = self.cfg
        assert c.global_batch % n_shards == 0
        rows_per = c.global_batch // n_shards
        rows = (np.arange(rows_per, dtype=np.uint64)
                + np.uint64(shard_index * rows_per))
        toks = self._tokens(step, rows)
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
