"""Task-batch padding for the batched DSE routes (single device).

The reference shards the task axis over a device mesh; on one card only
its padding rule remains: a task batch is padded to its power-of-two
bucket by repeating the last row (seed included), and the padded rows'
results are computed and discarded.  Every task lane is independent, so
padding never changes a real row's Selection.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def pow2_bucket(n: int, floor: int = 2) -> int:
    """Smallest power of two >= max(n, floor)."""
    return 1 << (max(int(n), floor) - 1).bit_length()


def pad_rows(n: int, multiple: int) -> Optional[np.ndarray]:
    """Row gather padding `n` up to the next multiple with the
    repeat-last-row rule; None when already aligned."""
    if multiple <= 1 or n % multiple == 0:
        return None
    target = ((n + multiple - 1) // multiple) * multiple
    return np.concatenate([np.arange(n), np.full(target - n, n - 1)])


def pad_tasks(tasks, seeds: np.ndarray):
    """Pad a task batch (and its per-row seed array) to
    ``pow2_bucket(n, floor=1)`` rows.  Returns ``(tasks, seeds, n_real)``."""
    n = len(tasks)
    if n == 0:
        return tasks, seeds, 0
    rows = pad_rows(n, pow2_bucket(n, floor=1))
    if rows is None:
        return tasks, seeds, n
    return tasks.take(rows), np.asarray(seeds)[rows], n
