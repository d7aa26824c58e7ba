"""The port's sharding rules, meshes and task-mesh helpers against the
reference's, on one process.

- ``train/shardings``: ``param_specs`` (fsdp on and off) of all ten archs'
  full-width param structs, ``state_spec`` of each arch's decode states,
  ``activation_spec`` under the three ``act_shard`` policies and
  ``batch_specs`` equal the reference's, on ``AbstractMesh`` shapes
  (1, 1), (4, 1), (2, 2), (16, 16), (2, 16, 16) and a 'model'-only (4,).
- Mirrors of the reference's single-device ``tests/test_shard.py``: the
  specs on model-only, size-1 and full meshes, ``make_host_mesh``'s
  override, submesh and errors, the batcher's shard multiple and its
  following the task mesh, and ``pad_tasks`` held to the reference's
  under the same fake mesh.
- The meshes of one rank: a world of one started from a store, the
  production meshes' errors; hymba's, xlstm's and whisper's steps on a
  'model' axis, run on two gloo ranks.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import configs as JC
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core import shard as JSD
from repro.dataset.generator import DSETask as JTask
from repro.train import shardings as JSH
from repro.train import step as JTS

from repro_torch import configs as TC
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import shard
from repro_torch.dataset.generator import DSETask
from repro_torch.launch import mesh as TMESH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.request import DSERequest
from repro_torch.train import shardings as SH
from repro_torch.train import step as TTS

ARCHS = TC.list_archs()
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "model4": ((4,), ("model",)),
}


def _mesh(name):
    return AbstractMesh(*MESHES[name])


def _ref_specs(tree) -> dict:
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(spec)
    return out


def _port_specs(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _port_specs(tree[key], path + (str(key),)).items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in _port_specs(t, path + (str(i),)).items()}
    return {"/".join(path): tuple(tree)}


_STRUCTS = {}


def _structs(arch):
    if arch not in _STRUCTS:
        jm, tm = JC.get_arch(arch), TC.get_arch(arch)
        _STRUCTS[arch] = (jm, tm, JTS.param_structs(jm, jax.numpy.float32),
                          TTS.param_structs(tm))
    return _STRUCTS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """Every leaf's spec at the same path, every mesh, fsdp on and off."""
    _, _, jp, tp = _structs(arch)
    for name in MESHES:
        mesh = _mesh(name)
        for fsdp in (True, False):
            want = _ref_specs(JSH.param_specs(jp, mesh, fsdp=fsdp))
            got = _port_specs(SH.param_specs(tp, mesh, fsdp=fsdp))
            assert got == want, (arch, name, fsdp)
    # the rules do shard something at production shapes
    specs = _port_specs(SH.param_specs(tp, _mesh("16x16")))
    assert any(s != (None,) * len(s) for s in specs.values())


def _shapes(tree) -> list:
    return sorted((tuple(x.shape) for x in jax.tree_util.tree_leaves(tree)
                   if hasattr(x, "shape") and len(x.shape) >= 1), key=str)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch):
    """``state_spec`` of every decode-state leaf of the decode_32k cell
    (and a batch of 1 at 500k) equals the reference's."""
    jm, tm, jp, tp = _structs(arch)
    for shape_name in ("decode_32k", "long_500k"):
        js = JSHAPES[shape_name]
        b = js.global_batch
        jst = JTS.state_structs(jp, jm, b, js.seq_len, jax.numpy.float32)
        tst = TTS.state_structs(tp, tm, b, js.seq_len)
        tshapes = _shapes([t for t in _leaves(tst) if torch.is_tensor(t)])
        jshapes = [s for s in _shapes(jst) if len(s) > 1 or s in tshapes]
        assert [s for s in tshapes if len(s) > 1] == \
            [s for s in jshapes if len(s) > 1]
        for name in MESHES:
            mesh = _mesh(name)
            for s in jshapes:
                assert SH.state_spec(s, mesh, b) == \
                    tuple(JSH.state_spec(s, mesh, b)), (arch, name, s)
        spec_tree = SH.state_specs(tst, _mesh("16x16"), b)
        assert all(isinstance(x, SH.P) or not torch.is_tensor(t)
                   for x, t in zip(_leaves(spec_tree, P_leaf=True),
                                   _leaves(tst)))


def _leaves(tree, P_leaf=False):
    if P_leaf and isinstance(tree, SH.P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], P_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t, P_leaf)]
    return [tree]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_and_batch_specs_match_reference(mesh_name):
    mesh = _mesh(mesh_name)
    for policy in SH.ACT_SHARD:
        for batch, d, seq in ((1, 512, 64), (32, 4096, 4096), (64, 2048, 8),
                              (30, 768, 1000), (256, 5120, 32768)):
            with JSH.use_mesh(mesh, act_shard=policy):
                want = JSH.activation_spec(mesh, batch, d, seq=seq)
            with SH.use_mesh(mesh, act_shard=policy):
                got = SH.activation_spec(mesh, batch, d, seq=seq)
            assert got == tuple(want), (policy, batch, d, seq)
    for arch in ARCHS:
        jm, tm = JC.get_arch(arch), TC.get_arch(arch)
        for shape_name, shp in SHAPES.items():
            want = JTS.batch_specs(jm, JSHAPES[shape_name], mesh)
            got = TTS.batch_specs(tm, shp, mesh)
            assert {k: tuple(v) for k, v in want.items()} == got, \
                (arch, shape_name)


def test_act_shard_must_be_a_policy():
    with pytest.raises(ValueError, match="act_shard"):
        with SH.use_mesh(None, act_shard="rows"):
            pass


# ---------------------------------------------------------------------------
# mirrors of the reference's single-device tests/test_shard.py
# ---------------------------------------------------------------------------
def _spec_axes(spec):
    out = []
    for entry in spec:
        if entry is None:
            continue
        assert entry != (), f"spec holds an empty tuple: {spec}"
        out.extend(entry if isinstance(entry, tuple) else (entry,))
    return out


class ModelOnlyMesh:
    shape = {"model": 8}


class OneDeviceMesh:
    shape = {"data": 1, "model": 1}


class FullMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


class FakeMesh:
    shape = {"data": 4, "model": 1}


def test_specs_on_model_only_mesh_never_name_absent_axes():
    mesh = ModelOnlyMesh()
    act = SH.activation_spec(mesh, batch=32, d_model=512)
    assert act == SH.P(None, None, "model"), act
    st = SH.state_spec((4, 32, 4096, 8, 64), mesh, batch=32)
    for ax in _spec_axes(act) + _spec_axes(st):
        assert ax in mesh.shape, (act, st)


def test_specs_drop_size1_mesh_axes():
    act = SH.activation_spec(OneDeviceMesh(), batch=32, d_model=512)
    assert act == SH.P(None, None, None), act
    assert SH.norm_axes(("pod", "data"), OneDeviceMesh()) is None
    assert SH.norm_axes((), None) is None
    assert SH.norm_axes("data", None) == ("data",)


def test_specs_on_full_mesh_unchanged():
    act = SH.activation_spec(FullMesh(), batch=64, d_model=4096)
    assert act == SH.P(("pod", "data"), None, "model"), act


def test_make_host_mesh_override_and_submesh():
    n = dist.get_world_size() if dist.is_initialized() else 1
    default = make_host_mesh(device="cpu")
    assert SH.mesh_sizes(default) == {"data": n, "model": 1}
    assert dist.is_initialized() and dist.get_world_size() == n
    full = make_host_mesh(shape=(n, 1), device="cpu")
    assert SH.mesh_sizes(full) == {"data": n, "model": 1}
    sub = make_host_mesh(shape=(1, 1), device="cpu")
    assert SH.mesh_sizes(sub) == {"data": 1, "model": 1}
    assert sub.mesh.flatten().tolist() == [0]
    named = make_host_mesh(shape=(1,), axes=("tasks",), device="cpu")
    assert SH.mesh_sizes(named) == {"tasks": 1}
    assert shard.n_task_shards(default) == n and shard.task_axes(named) is None


def test_make_host_mesh_rejects_oversized_shape():
    n = dist.get_world_size() if dist.is_initialized() else 1
    make_host_mesh(device="cpu")
    n = dist.get_world_size()
    with pytest.raises(ValueError) as e:
        make_host_mesh(shape=(n + 1, 2), device="cpu")
    assert str(2 * (n + 1)) in str(e.value) and str(n) in str(e.value)
    with pytest.raises(ValueError):
        make_host_mesh(shape=(1, 1), axes=("data",), device="cpu")
    with pytest.raises(AssertionError):
        make_host_mesh(axes=("data", "model"), device="cpu")
    # the production meshes want 256 and 512 ranks, as jax.make_mesh does
    for multi in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            TMESH.make_production_mesh(multi_pod=multi, device="cpu")
    assert SH.mesh_sizes(TMESH.make_mesh((n,), ("data",), device="cpu")) \
        == {"data": n}


def test_model_axis_execution_raises(tmp_path):
    """A 'model' axis larger than 1 serves and trains every ported arch
    (``tests/test_torch_model_axis.py``, ``_train.py``, ``_recurrent.py``):
    hymba's, xlstm's and whisper's train, prefill and decode steps build
    there (ROADMAP Queue 1 item 6c, done) and, on two gloo ranks of a
    (1, 2) mesh, run: the prefill's logits within 1e-5·max(1, max|logit|)
    and the train step's loss within 1e-5 relative of one rank's,
    hymba's and xlstm's ``Engine`` one rank's tokens.  The decode step
    still needs the states' cache length there, and 'model' of size 1
    executes."""
    import os
    import pathlib
    import pickle
    import subprocess
    import sys

    mesh = AbstractMesh((2, 2), ("data", "model"))
    arches = ("hymba-1.5b", "xlstm-1.3b", "whisper-small")
    for arch in ("stablelm-1.6b",) + arches:
        m = TC.get_reduced(arch)
        step, _ = TTS.make_train_step(m, mesh=mesh)
        assert callable(step) and callable(step.loss_and_grads)
        assert callable(TTS.make_prefill_step(m, mesh=mesh))
        assert callable(TTS.make_decode_step(m, mesh=mesh, cache_len=16))
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(
        root / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ranks = [subprocess.Popen(
        [sys.executable, str(root / "tests" / "_torch_ranks.py"), str(r),
         "2", str(tmp_path / "store"), str(tmp_path), "steps"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(ranks, logs):
        assert p.returncode == 0, log.decode(errors="replace")[-4000:]
    seen = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            seen.append(pickle.load(f))
    assert "error" not in seen[0] and "error" not in seen[1], seen
    for arch in arches:
        one = seen[0]["runs"][arch]["one"]["loss"]
        for rec in (seen[r]["runs"][arch] for r in range(2)):
            want = rec["one_logits"]
            scale = max(1.0, float(np.abs(want).max()))
            assert np.abs(rec["logits"] - want).max() <= 1e-5 * scale
            assert abs(rec["train"]["loss"] - one) <= 1e-5 * abs(one)
            if "tokens" in rec:
                assert rec["tokens"] == rec["one_tokens"]
    # the decode step needs the states' cache length there
    m = TC.get_reduced("stablelm-1.6b")
    with pytest.raises(ValueError, match="cache_len"):
        TTS.make_decode_step(m, mesh=mesh)
    # 'model' of size 1 executes
    TTS.make_train_step(m, mesh=OneDeviceMesh())


def _req(rid, model_name="m", seed=None):
    return DSERequest(rid=rid, model_name=model_name,
                      net_idx=np.zeros(3, np.int64), lat_obj=1.0, pow_obj=1.0,
                      seed=rid if seed is None else seed)


def test_batcher_pads_to_shard_multiple():
    mb = MicroBatcher(max_batch=64)
    for rid in range(5):
        mb.admit(_req(rid))
    with shard.task_mesh(FakeMesh()):
        b = mb.next_batch()
    assert (b.n_real, b.padded_size) == (5, 8)
    np.testing.assert_array_equal(b.seeds, [0, 1, 2, 3, 4, 4, 4, 4])
    assert len(b.tasks) == 8
    for pad_pow2, n, mesh, want in ((False, 5, FakeMesh(), 8),
                                    (False, 3, FakeMesh(), 4),
                                    (True, 5, None, 8), (False, 5, None, 5)):
        mb = MicroBatcher(max_batch=64, pad_pow2=pad_pow2)
        for rid in range(n):
            mb.admit(_req(rid))
        with shard.task_mesh(mesh):
            assert mb.next_batch().padded_size == want, (pad_pow2, n, mesh)


def test_batcher_follows_active_task_mesh():
    mb = MicroBatcher(max_batch=64)
    for rid in range(3):
        mb.admit(_req(rid))
    with shard.task_mesh(FakeMesh()):
        assert mb.next_batch().padded_size == 4
    for rid in range(3):
        mb.admit(_req(rid + 10))
    assert mb.next_batch().padded_size == 4  # no mesh: plain pow2


@pytest.mark.parametrize("n_tasks", [1, 5, 6, 8, 9])
def test_pad_tasks_matches_reference(n_tasks):
    """The same padded rows and seeds as the reference's, with the same
    fake 4-way mesh and with none."""
    net = np.arange(2 * n_tasks).reshape(n_tasks, 2)
    lat, pw = np.arange(n_tasks, dtype=float), np.arange(n_tasks) + 10.0
    seeds = np.arange(n_tasks, dtype=np.int64) + 100
    for mesh in (FakeMesh(), None):
        jt, js, jn = JSD.pad_tasks(JTask(net, lat, pw), seeds, mesh=mesh)
        tt, ts, tn = shard.pad_tasks(DSETask(net, lat, pw), seeds, mesh=mesh)
        assert tn == jn == n_tasks
        np.testing.assert_array_equal(tt.net_idx, jt.net_idx)
        np.testing.assert_array_equal(tt.lat_obj, jt.lat_obj)
        np.testing.assert_array_equal(ts, js)
        assert shard.n_task_shards(mesh) == JSD.n_task_shards(mesh)
        assert shard.task_axes(mesh) == JSD.task_axes(mesh)


def test_one_rank_mesh_is_the_identity():
    """On a world of one the task helpers change nothing and call no
    collective: ``put_sharded`` and ``replicate`` return their input."""
    mesh = make_host_mesh(device="cpu")
    if dist.get_world_size() != 1:
        pytest.skip("this process runs in a larger world")
    x = np.arange(8)
    with shard.task_mesh(mesh):
        assert shard.put_sharded(x) is x
        assert shard.active_n_shards() == 1
        tree = {"w": torch.ones(2)}
        assert shard.replicate(tree) is tree
        assert shard.map_rows(lambda a: list(a * 2), x) == list(x * 2)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_host_mesh(device="cpu")
    assert SH.placements(SH.P("data", None), mesh) == (Shard(0), Replicate())
    assert SH.placements(SH.P(None, "model"), mesh) == (Replicate(), Shard(1))
    assert SH.placements(SH.P(None, None), mesh) == (Replicate(),) * 2
