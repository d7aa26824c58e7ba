"""The port's `CheckpointManager` (``repro_torch.checkpoint.manager``)
against the reference's, on the CPU.

- One format: a step saved by the reference restores in the port bit for
  bit, and the reverse (G's params at 2 x 32 on dnnweaver, and a nested
  tree of dicts, lists, tuples and None), both ways through the leaf
  order of ``jax.tree_util.tree_flatten``; the port's flattening is that
  order.  The port restores onto the ``like`` leaves' devices and dtypes.
- The reference's ``tests/test_checkpoint.py`` cases on the port:
  corruption and tamper detected, ``restore_latest`` falling back past a
  corrupted newest step, a failed re-save keeping the old copy, the
  pre-checksum format, retention, no pruning on an unverified save, and
  a torn prune.  Restored G params re-attached explore to the same
  Selections (exact).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JM
from repro.core import gan as JG
from repro.design_models.dnnweaver import DnnWeaverModel as JDnnWeaver
from repro_torch.checkpoint import manager as M
from repro_torch.checkpoint.manager import (CheckpointCorruptionError,
                                            CheckpointManager)
from repro_torch.convert import g_params_from_numpy
from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core.dse_api import GANDSE
from repro_torch.core.explorer import ExplorerConfig
from repro_torch.dataset.generator import generate_dataset, generate_tasks
from repro_torch.design_models import DnnWeaverModel
from repro_torch.optim import tree_leaves
from repro_torch.serve.faults import corrupt_checkpoint

MODEL = DnnWeaverModel()


def _tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((8, 4)) * scale).astype(np.float32),
            "b": np.arange(4, dtype=np.float32) * scale}


def _nested(seed=0):
    """Dicts (keys out of order), a list, a tuple, None, mixed dtypes."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"z": [f(3), {"q": f(2, 2), "a": np.arange(5, dtype=np.int32)}],
            "m": (f(1), None, f(4, 1)), "a": {"y": f(2), "x": f(6)}}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_tree_equal(a, b):
    la, lb = M._flatten(a)[0], M._flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _g_numpy(key=11, layers=2):
    cfg = JG.GANConfig(n_net=MODEL.net_space.n_dims).scaled(layers, 32)
    return jax.tree.map(np.asarray, JG.init_generator(
        jax.random.PRNGKey(key), cfg, JDnnWeaver().space))


# ---------------------------------------------------------------------------
# one format for both packages
# ---------------------------------------------------------------------------
def test_flatten_order_is_jax_tree_order():
    tree = _nested()
    leaves, rebuild = M._flatten(tree)
    assert [x.tolist() for x in leaves] == \
        [x.tolist() for x in _leaves(tree)]
    again = rebuild(leaves)
    assert jax.tree_util.tree_structure(again) == \
        jax.tree_util.tree_structure(tree)
    g = g_params_from_numpy(_g_numpy(), "cpu")
    names = [id(t) for t in M._flatten(g)[0]]
    assert names == [id(p[k]) for p in g["layers"] for k in ("b", "w")]


@pytest.mark.parametrize("which", ["g_params", "nested"])
def test_reference_step_restores_in_the_port(tmp_path, which):
    tree = _g_numpy() if which == "g_params" else _nested()
    JM.CheckpointManager(str(tmp_path)).save(3, tree, extra={"by": "ref"})
    ck = CheckpointManager(str(tmp_path))
    assert ck.steps() == [3] and ck.restore_extra(3) == {"by": "ref"}
    if which == "g_params":
        like = g_params_from_numpy(tree, "cpu")
        got = ck.restore(3, like)
        assert all(isinstance(x, torch.Tensor) for x in M._flatten(got)[0])
    else:
        got = ck.restore(3, tree)
    _assert_tree_equal(got, tree)


@pytest.mark.parametrize("which", ["g_params", "nested"])
def test_port_step_restores_in_the_reference(tmp_path, which):
    if which == "g_params":
        want = _g_numpy()
        tree = g_params_from_numpy(want, "cpu")
    else:
        want = tree = _nested()
    sdir = CheckpointManager(str(tmp_path)).save(5, tree)
    assert sorted(os.listdir(sdir)) == ["host_0.npz", "manifest.json"]
    ck = JM.CheckpointManager(str(tmp_path))
    ck.verify(5)
    got = ck.restore(5, want)
    for x, y in zip(_leaves(got), _leaves(want)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    with open(os.path.join(sdir, "manifest.json")) as f:
        mine = json.load(f)
    JM.CheckpointManager(str(tmp_path / "ref")).save(5, want)
    with open(tmp_path / "ref" / "step_000000005" / "manifest.json") as f:
        ref = json.load(f)
    assert mine["checksums"] == ref["checksums"]
    assert mine["n_leaves"] == ref["n_leaves"]


def test_restore_onto_like_dtype_and_device(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "n": torch.arange(3, dtype=torch.int64)}
    ck.save(1, t)
    like = {"w": torch.zeros(2, 3, dtype=torch.float64),
            "n": torch.zeros(3, dtype=torch.int64)}
    got = ck.restore(1, like)
    assert got["w"].dtype == torch.float64 and got["n"].dtype == torch.int64
    assert torch.equal(got["w"], t["w"].double())
    assert torch.equal(got["n"], t["n"])
    with pytest.raises(AssertionError):
        ck.restore(1, {"w": torch.zeros(3, 2), "n": torch.zeros(3)})


def test_restore_keeps_the_like_trees_dict_order(tmp_path):
    """The file holds the leaves in jax's order (keys sorted), but the
    restored dicts keep `like`'s key order at every level: the port's
    ``tree_leaves`` follows it, so a global norm (the train step's clip)
    sums a restored state's leaves in the order it summed the saved one's,
    and a restarted run replays the whole run's bits."""
    tree = {"z": {"b": torch.ones(2), "a": torch.zeros(3)},
            "y": [{"w": torch.arange(4.0), "c": torch.full((1,), 7.0)}]}
    CheckpointManager(str(tmp_path)).save(1, tree)
    got = CheckpointManager(str(tmp_path)).restore(1, tree)
    assert list(got) == ["z", "y"] and list(got["z"]) == ["b", "a"]
    assert list(got["y"][0]) == ["w", "c"]
    for x, y in zip(tree_leaves(got), tree_leaves(tree)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the reference's checkpoint contracts on the port
# ---------------------------------------------------------------------------
def test_corrupted_payload_raises_on_restore_and_verify(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    tree = _tree(0)
    sdir = ck.save(1, tree)
    ck.verify(1)
    corrupt_checkpoint(sdir, seed=3)
    with pytest.raises(CheckpointCorruptionError) as ei:
        ck.restore(1, tree)
    msg = str(ei.value)
    assert "step 1" in msg and ("checksum mismatch" in msg
                                or "unreadable payload" in msg)
    with pytest.raises(CheckpointCorruptionError):
        ck.verify(1)
    assert ck.steps() == [1]


def test_restore_latest_skips_corrupted_newest(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep_last_n=0)
    good = _tree(1, scale=2.0)
    ck.save(1, _tree(0))
    ck.save(2, good)
    corrupt_checkpoint(ck.save(3, _tree(2, scale=3.0)), seed=7)
    step, tree = ck.restore_latest(good)
    assert step == 2
    _assert_tree_equal(tree, good)


def test_restore_latest_none_when_all_corrupted(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    for s in (1, 2):
        corrupt_checkpoint(ck.save(s, _tree(s)), seed=s)
    assert ck.restore_latest(_tree(0)) is None


def test_manifest_checksum_tamper_detected(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    tree = _tree(0)
    ck.save(5, tree)
    mpath = os.path.join(ck._step_dir(5), "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    first = next(iter(manifest["checksums"]))
    manifest["checksums"][first] ^= 0xDEAD
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointCorruptionError, match=first):
        ck.restore(5, tree)


class _Explodes:
    """A leaf whose array conversion raises mid-save."""

    def __array__(self, *a, **kw):
        raise RuntimeError("mid-save crash")


def test_resave_failure_preserves_previous_copy(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    v1 = _tree(0)
    ck.save(1, v1)
    with pytest.raises(RuntimeError, match="mid-save crash"):
        ck.save(1, {"w": np.zeros((8, 4), np.float32), "b": _Explodes()})
    _assert_tree_equal(ck.restore(1, v1), v1)
    assert [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")] == []


def test_resave_success_replaces_atomically(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, _tree(0))
    v2 = _tree(9, scale=5.0)
    ck.save(1, v2)
    _assert_tree_equal(ck.restore(1, v2), v2)
    assert ck.steps() == [1]
    assert [d for d in os.listdir(tmp_path) if d.startswith(".old_")] == []


def test_pre_checksum_checkpoints_still_restore(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    tree = _tree(0)
    ck.save(1, tree)
    mpath = os.path.join(ck._step_dir(1), "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["checksums"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    _assert_tree_equal(ck.restore(1, tree), tree)


def test_generator_params_roundtrip_attach_parity(tmp_path):
    cfg = G.GANConfig(n_net=MODEL.net_space.n_dims).scaled(
        layers=1, neurons=32, batch_size=64, lr=1e-3)
    engine = GANDSE(MODEL, cfg, ExplorerConfig(prob_threshold=0.1,
                                               max_candidates=128),
                    device="cpu")
    ds = generate_dataset(MODEL, 256, seed=0)
    params = G.init_generator(prng.prng_key(torch.tensor(11)), cfg,
                              MODEL.space, "cpu")
    engine.attach(ds, params)
    tasks = generate_tasks(MODEL, 6, seed=4)
    before = engine.explore_tasks(tasks, seed=3)
    ck = CheckpointManager(str(tmp_path))
    ck.save(100, params, extra={"model": MODEL.name})
    assert ck.restore_extra(100)["model"] == MODEL.name
    engine.attach(ds, ck.restore(100, params))
    after = engine.explore_tasks(tasks, seed=3)
    for i, (ra, rb) in enumerate(zip(before, after)):
        sa, sb = ra.selection, rb.selection
        assert sa.n_candidates == sb.n_candidates, i
        if sa.cfg_idx is not None:
            np.testing.assert_array_equal(sa.cfg_idx, sb.cfg_idx)
        assert sa.latency == sb.latency and sa.power == sb.power, i


def test_retention_prunes_to_keep_last_n(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep_last_n=2)
    for s in range(1, 6):
        ck.save(s, _tree(s))
    assert ck.steps() == [4, 5]
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_000000004", "step_000000005"]
    _assert_tree_equal(ck.restore(5, _tree(5)), _tree(5))


def test_no_prune_on_unverified_save(tmp_path, monkeypatch):
    ck = CheckpointManager(str(tmp_path), keep_last_n=1)
    ck.save(1, _tree(1))

    def bad_verify(step):
        raise CheckpointCorruptionError(f"step {step} damaged")

    monkeypatch.setattr(ck, "verify", bad_verify)
    ck.save(2, _tree(2))
    assert ck.steps() == [1, 2]


def test_torn_prune_crash_leaves_consistent_state(tmp_path, monkeypatch):
    ck = CheckpointManager(str(tmp_path), keep_last_n=1)
    ck.save(1, _tree(1))
    real = M.shutil.rmtree
    calls = {"prune": 0}

    def flaky(path, **kw):
        if os.path.basename(path).startswith(".prune_"):
            calls["prune"] += 1
            if calls["prune"] >= 2:
                raise OSError("disk error mid-prune")
        return real(path, **kw)

    monkeypatch.setattr(M.shutil, "rmtree", flaky)
    with pytest.raises(OSError, match="mid-prune"):
        ck.save(2, _tree(2))
    assert ck.steps() == [2]
    step, tree = ck.restore_latest(_tree(2))
    assert step == 2
    _assert_tree_equal(tree, _tree(2))
    assert any(d.startswith(".prune_") for d in os.listdir(tmp_path))
    monkeypatch.setattr(M.shutil, "rmtree", real)
    ck.save(3, _tree(3))
    assert ck.steps() == [3]
    assert [d for d in os.listdir(tmp_path)
            if d.startswith((".prune_", ".old_step_"))] == []
