"""Sharded checkpoint manager: atomic, checksummed, keep-N, auto-resume.

The reference's format, read and written by both packages: a step saved
by ``repro.checkpoint.manager`` restores here bit for bit, and the
reverse.  The leaves of a tree (nested dicts, lists and tuples of tensors
or arrays) are named ``leaf_{i}`` in ``jax.tree_util.tree_flatten``'s
order — dict keys sorted, lists and tuples in order, None holding no
leaf — so G's params ``{"layers": [{"w", "b"}, ...]}`` are ``layers[0].b,
layers[0].w, layers[1].b, ...`` in either package.  ``save`` copies card
tensors to the host; ``restore(step, like)`` returns tensors on each
``like`` leaf's device and dtype (numpy arrays for numpy leaves).

Layout:  <dir>/step_<n>/host_<i>.npz + manifest.json (written last — temp
file + ``os.replace`` inside the staging dir, then the whole step dir is
published by a single rename — so a partially-written checkpoint is never
resumable and the previous checkpoint for the same step survives a crash
mid-save).  Each host writes only the leaves (or leaf-shards) it owns; on
this single-host container host_0 holds everything, but the format and the
restore path are multi-host shaped (restore validates the manifest's
host_count and step).

Integrity: the manifest records a crc32 per leaf; ``restore`` and
``verify`` recompute them and raise `CheckpointCorruptionError` (with the
offending file and leaf) on any mismatch or unreadable payload — a
corrupted checkpoint must be *detected at swap time*, never silently
attached as garbage params (the serving tier's corrupted-swap recovery,
exercised by `repro_torch.serve.faults.corrupt_checkpoint`).

Fault-tolerance contract used by launch/train.py and the serving tier:
  * save(step, tree) never corrupts the previous checkpoint;
  * latest_step() -> most recent step with a valid (parseable) manifest;
  * restore(step, like) -> tree matching `like`'s structure, devices and
    dtypes, or CheckpointCorruptionError — GANDSE.attach-compatible: `like`
    may be live generator params (only device/shape/dtype metadata is
    consulted) and the restored tree feeds straight into `GANDSE.attach` /
    `DSEServer.swap`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity validation (checksum mismatch, missing
    or unreadable payload).  Callers recover by falling back to the last
    valid step — never by attaching the damaged tree."""


def _flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves, rebuild): the leaves in jax's tree order (dict keys
    sorted, lists, tuples and NamedTuples in order, None empty) and a
    function that rebuilds the tree's structure from a list of new
    leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    elif tree is None:
        return [], lambda leaves: None
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, sub), n in zip(parts, counts):
            out.append(sub(leaves[i:i + n]))
            i += n
        if keys is not None:
            # in the dict's own key order: the order of tree_leaves, so a
            # global norm sums the restored leaves as it summed the saved
            built = dict(zip(keys, out))
            return {k: built[k] for k in tree}
        # a NamedTuple (an optimizer's AdamState) takes its fields as
        # arguments, in field order, as jax flattens it
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)

    return [leaf for p in parts for leaf in p[0]], rebuild


def _flatten_with_names(tree):
    leaves, rebuild = _flatten(tree)
    names = [f"leaf_{i}" for i in range(len(leaves))]
    return leaves, names, rebuild


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array (card tensors copied to the host)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, like):
    """`arr` as `like`'s kind: a tensor on its device and dtype, else a
    numpy array of its dtype."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=like.device, dtype=like.dtype)
    return arr.astype(like.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    #: retention bound: prune to the newest N steps after every save (0
    #: disables pruning).  Retention is conservative by construction: it
    #: deletes nothing unless the just-saved step verifies (manifest +
    #: checksums), a pruned step is atomically de-listed (rename) before
    #: its payload is deleted, and stray aside/prune dirs left by crashed
    #: saves or prunes are swept on the next save — a long online loop
    #: (`repro_torch.serve.online`) holds steady disk instead of filling it.
    keep_last_n: int = 3
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # ---- paths -------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def _manifest(self, step: int) -> str:
        return os.path.join(self._step_dir(step), "manifest.json")

    def _payload(self, step: int) -> str:
        return os.path.join(self._step_dir(step),
                            f"host_{self.host_index}.npz")

    # ---- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        leaves, names, _ = _flatten_with_names(tree)
        sdir = self._step_dir(step)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_save_")
        try:
            arrs = {n: _to_host(l) for n, l in zip(names, leaves)}
            np.savez(os.path.join(tmp, f"host_{self.host_index}.npz"), **arrs)
            manifest = {
                "step": step,
                "time": time.time(),
                "host_count": self.host_count,
                "n_leaves": len(leaves),
                "checksums": {n: _crc(a) for n, a in arrs.items()},
                "extra": extra or {},
            }
            # manifest last, via temp file + os.replace: its presence (and
            # parseability) is what marks the step complete
            mtmp = os.path.join(tmp, ".manifest.json.tmp")
            with open(mtmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, os.path.join(tmp, "manifest.json"))
            if os.path.exists(sdir):
                # keep the old step alive until the new one is in place
                # (a crash between these renames leaves the aside copy,
                # invisible to steps(), instead of zero checkpoints)
                aside = os.path.join(self.directory,
                                     f".old_step_{step:09d}")
                shutil.rmtree(aside, ignore_errors=True)
                os.rename(sdir, aside)
                os.rename(tmp, sdir)           # atomic publish
                shutil.rmtree(aside, ignore_errors=True)
            else:
                os.rename(tmp, sdir)           # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc(new_step=step)
        return sdir

    # ---- restore ---------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            if not d.startswith("step_"):
                continue
            mpath = os.path.join(self.directory, d, "manifest.json")
            try:
                with open(mpath) as f:
                    json.load(f)
            except (OSError, ValueError):
                continue               # absent or torn manifest: not resumable
            out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _load_manifest(self, step: int) -> dict:
        with open(self._manifest(step)) as f:
            return json.load(f)

    def verify(self, step: int) -> dict:
        """Validate one step's payload against its manifest checksums
        without building the output tree; returns the manifest.  Raises
        `CheckpointCorruptionError` on any mismatch — the pre-swap gate."""
        manifest = self._load_manifest(step)
        self._verified_arrays(step, manifest)
        return manifest

    def _verified_arrays(self, step: int, manifest: dict) -> dict:
        path = self._payload(step)
        try:
            with np.load(path) as data:
                arrs = {n: data[n] for n in data.files}
        except Exception as e:
            raise CheckpointCorruptionError(
                f"checkpoint step {step}: unreadable payload {path}: "
                f"{e}") from e
        sums = manifest.get("checksums")
        if sums is not None:           # absent on pre-checksum checkpoints
            for n, want in sums.items():
                if n not in arrs:
                    raise CheckpointCorruptionError(
                        f"checkpoint step {step}: leaf '{n}' missing "
                        f"from {path}")
                got = _crc(arrs[n])
                if got != int(want):
                    raise CheckpointCorruptionError(
                        f"checkpoint step {step}: checksum mismatch on "
                        f"leaf '{n}' of {path} (stored {want}, "
                        f"recomputed {got}) — refusing to restore "
                        f"corrupted params")
        return arrs

    def restore(self, step: int, like: Any) -> Any:
        manifest = self._load_manifest(step)
        leaves, names, rebuild = _flatten_with_names(like)
        assert manifest["n_leaves"] == len(leaves), "tree structure changed"
        data = self._verified_arrays(step, manifest)
        new_leaves = []
        for n, l in zip(names, leaves):
            arr = data[n]
            # only `like`'s device/shape/dtype metadata is consulted
            assert arr.shape == tuple(l.shape), (n, arr.shape, l.shape)
            new_leaves.append(_like(arr, l))
        return rebuild(new_leaves)

    def restore_latest(self, like: Any):
        """(step, tree) of the newest step that passes validation, skipping
        corrupted ones (each raises internally and is passed over), or
        None when no step restores cleanly — the swap-time recovery path:
        a damaged newest checkpoint falls back to the previous good one."""
        for step in reversed(self.steps()):
            try:
                return step, self.restore(step, like)
            except CheckpointCorruptionError:
                continue
        return None

    def restore_extra(self, step: int) -> dict:
        return self._load_manifest(step)["extra"]

    # ---- gc ----------------------------------------------------------------
    def _gc(self, new_step: Optional[int] = None) -> None:
        """``keep_last_n`` retention + stray sweep, run after every save.

        Prunes steps older than the newest ``keep_last_n`` — but only once
        the just-saved step passes ``verify`` (manifest parse + payload
        checksums): if the newest save is torn or already damaged, nothing
        is deleted, so the good history ``restore_latest`` falls back on
        survives.  Then sweeps aside/prune dirs (``.old_step_*``,
        ``.prune_*``) orphaned by a crash mid-save or mid-prune — they are
        invisible to ``steps()`` but used to leak disk forever.
        """
        if new_step is not None:
            try:
                self.verify(new_step)
            except (CheckpointCorruptionError, OSError):
                return      # never prune on the strength of an unverified save
        if self.keep_last_n > 0:
            for s in self.steps()[: -self.keep_last_n]:
                self._remove_step(s)
        for d in os.listdir(self.directory):
            if d.startswith((".old_step_", ".prune_")):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)

    def _remove_step(self, step: int) -> None:
        """Crash-safe prune: rename the step dir aside first (one atomic
        op de-lists it from ``steps()``, so a crash mid-delete can never
        leave a listed step with a half-deleted payload), then delete."""
        doomed = os.path.join(self.directory, f".prune_step_{step:09d}")
        shutil.rmtree(doomed, ignore_errors=True)
        try:
            os.rename(self._step_dir(step), doomed)
        except OSError:
            return          # already gone (earlier crashed prune finished it)
        shutil.rmtree(doomed, ignore_errors=True)
