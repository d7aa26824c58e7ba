"""Training across a 'model' axis, on a 4-rank gloo world on the CPU,
against one rank holding the whole tree and the reference's 4-device
jitted train step.

The module starts 4 ranks once (``tests/_torch_ranks.py ... train``, a
``FileStore`` under ``tmp_path``, one thread each); every rank builds the
(1, 4) and (2, 2) ('data', 'model') meshes and on each, for reduced
stablelm (MHA), qwen3 (GQA, qk-norm), gemma3 (one KV head, the window,
the tied table) and mixtral (E = 4: expert parallel on both meshes):

- shards the params by ``param_specs(fsdp=True)`` and takes one
  ``make_train_step`` step on its blocks (the batch's rows split over
  'data' on (2, 2)), beside one rank's step on the whole tree in the same
  MoE token groups: the loss within 1e-5 relative, every gradient block
  (before the clip) within 1e-5·max(1, max|g_leaf|) of that block of one
  rank's gradient, the clip scale within 1e-6 (the clip acting), the
  params after the step within rtol 1e-4 / atol 1e-5, or 2·lr where one
  rank's gradient is under 1e-6 (Adam's first step turns a sign flip at
  rounding into ±lr); params, mu and nu exactly the spec blocks' bytes;
- with remat on, the ``act_shard`` policies 'model', 'seq' and 'none'
  give the same loss and gradients within 1e-6, and the bytes kept at
  the save points (``saved_tensors_hooks``) under 'model' and 'seq' are
  1/m of 'none''s; ``microbatches`` 2 and 4 give one rank's.

On the (2, 2) mesh the collectives' backward passes are held to closed
forms: the f/g pair, the gather whose gradient is summed then cut, the
one whose gradient is only cut, FSDP's gather with the rows split and
not, and a save point's block gathered back.  Beside them the reference
runs ``jax.jit(make_train_step(m, mesh=make_host_mesh(shape)))`` with
params placed by ``param_shardings`` in two subprocesses, one a mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``): the loss and
the params after the step within the same tolerances.  On (2, 2) the
ranks also train reduced hymba, xlstm and whisper one step against one
rank (their parity in full is
``tests/test_torch_model_axis_recurrent.py``'s).

The ranks alone:
``for r in 0 1 2 3; do PYTHONPATH=src python tests/_torch_ranks.py $r 4
DIR/store DIR train & done; wait``.
"""
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core import prng
from repro_torch.models import base as MB
from repro_torch.train import parallel as PAR
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_ranks import (MICROBATCHES, MODEL_ARCHS,  # noqa: E402
                          MODEL_MESHES, TRAIN_BATCH, TRAIN_LR, TRAIN_SEQ,
                          Sizes, flat)

WORLD = 4
TIMEOUT_S = 240

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs as C
from repro.launch.mesh import make_host_mesh
from repro.models import base as MB
from repro.train import shardings as SH
from repro.train import step as TS
sys.path.insert(0, sys.argv[2])
from _torch_ranks import MODEL_ARCHS, TRAIN_LR, flat, train_batch
shape = tuple(int(n) for n in sys.argv[3].split("x"))
mesh = make_host_mesh(shape)
out = {}
for arch in MODEL_ARCHS:
    m = C.get_reduced(arch)
    params = MB.init_params(jax.random.PRNGKey(0), m)
    params = jax.device_put(params, SH.param_shardings(params, mesh))
    batch = {k: jnp.asarray(v.numpy(), jnp.int32)
             for k, v in train_batch(m.vocab).items()}
    step, optim = TS.make_train_step(m, lr=TRAIN_LR, remat=False, mesh=mesh)
    with mesh:
        p, _, met = jax.jit(step)(params, optim.init(params), batch)
    out[arch] = dict(loss=float(met["loss"]), params=flat(
        jax.tree.map(np.asarray, p)))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

CASES = [(shape, arch) for shape in MODEL_MESHES for arch in MODEL_ARCHS]
IDS = [f"{a}x{b}-{arch}" for (a, b), arch in CASES]
MESH_IDS = [f"{a}x{b}" for a, b in MODEL_MESHES]


def _env(**extra):
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{rank: what it saw}, and {shape: the reference's step}."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    refs = {shape: subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / f"ref{a}x{b}.pkl"),
         str(ROOT / "tests"), f"{a}x{b}"],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for shape in MODEL_MESHES for a, b in [shape]}
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_ranks.py"), str(r),
         str(WORLD), str(tmp / "store"), str(tmp), "train"],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    procs = ranks + list(refs.values())
    deadline = time.time() + TIMEOUT_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            logs.append(out.decode(errors="replace")[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    seen = {}
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            seen[r] = pickle.load(f)
        assert "error" not in seen[r], seen[r]["error"]
    reference = {}
    for a, b in MODEL_MESHES:
        with open(tmp / f"ref{a}x{b}.pkl", "rb") as f:
            reference[a, b] = pickle.load(f)
    return seen, reference


def _spec_paths(specs, path=()) -> dict:
    """{"a/b/0/c": P} of a spec tree, the paths of ``flat``."""
    if isinstance(specs, SH.P):
        return {"/".join(path): specs}
    if isinstance(specs, dict):
        return {k: v for key in specs
                for k, v in _spec_paths(specs[key], path + (key,)).items()}
    return {k: v for i, s in enumerate(specs)
            for k, v in _spec_paths(s, path + (str(i),)).items()}


def _layout(arch, shape):
    """(the mesh's sizes, {path: spec}, {path: full shape}) of `arch`."""
    mesh = Sizes(data=shape[0], model=shape[1])
    structs = MB.init_params(prng.prng_key(torch.tensor(0)),
                             TC.get_reduced(arch), torch.device("meta"))
    specs = _spec_paths(SH.param_specs(structs, mesh))
    return mesh, specs, {p: tuple(t.shape) for p, t in _paths(structs)}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, path + (str(i),))
    else:
        yield "/".join(path), tree


def _blocks_of(full: dict, specs: dict, mesh, coord) -> dict:
    """Each leaf's block at `coord` under its spec."""
    coord = dict(data=coord[0], model=coord[1])
    return {p: SH.local_block(torch.from_numpy(a), specs[p], mesh,
                              coord).numpy() for p, a in full.items()}


def _scale(a) -> float:
    return max(1.0, float(np.abs(a).max()))


def _runs(world, shape, arch):
    """[(coordinate, this rank's run)], and rank 0's one-rank run."""
    seen = world[0]
    runs = [(seen[r][shape]["coord"], seen[r][shape]["training"][arch])
            for r in range(WORLD)]
    return [(c, t["sharded"]) for c, t in runs], runs[0][1]["one"]


def _hold_params(got: dict, want: dict, grads: dict):
    """rtol 1e-4 / atol 1e-5, or 2·lr where one rank's gradient is under
    1e-6."""
    for p, w in want.items():
        g, tiny = got[p], np.abs(grads[p]) < 1e-6
        off = np.abs(g - w)
        ok = np.where(tiny, off <= 2 * TRAIN_LR,
                      off <= 1e-5 + 1e-4 * np.abs(w))
        assert ok.all(), (p, float(off[~ok].max()))


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_train_loss_is_one_ranks(world, shape, arch):
    runs, one = _runs(world, shape, arch)
    for _, run in runs:
        for loss in (run["loss"], run["step_loss"]):
            assert abs(loss - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert run["loss"] == runs[0][1]["loss"]


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_train_gradient_blocks_are_one_ranks(world, shape, arch):
    """Every block of every gradient, before the clip, within
    1e-5·max(1, max|g_leaf|) of that block of one rank's gradient."""
    mesh, specs, _ = _layout(arch, shape)
    runs, one = _runs(world, shape, arch)
    for coord, run in runs:
        want = _blocks_of(one["grads"], specs, mesh, coord)
        assert run["grads"].keys() == want.keys()
        for p, w in want.items():
            assert run["grads"][p].shape == w.shape, p
            err = np.abs(run["grads"][p] - w).max() if w.size else 0.0
            assert err <= 1e-5 * _scale(one["grads"][p]), (p, err)


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_clip_scale_is_one_ranks(world, shape, arch):
    """The global norm of the blocks (each leaf counted once) gives one
    rank's clip scale; the gradient's norm exceeds clip_norm, so the clip
    acts."""
    runs, one = _runs(world, shape, arch)
    assert one["scale"] < 1.0
    for _, run in runs:
        assert abs(run["scale"] - one["scale"]) <= 1e-6
        assert run["scale"] == runs[0][1]["scale"]


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_params_after_a_step_are_one_ranks(world, shape, arch):
    mesh, specs, _ = _layout(arch, shape)
    runs, one = _runs(world, shape, arch)
    for coord, run in runs:
        _hold_params(run["params"],
                     _blocks_of(one["params"], specs, mesh, coord),
                     _blocks_of(one["grads"], specs, mesh, coord))


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_replicated_leaves_are_the_same_bits_on_every_rank(world, shape,
                                                           arch):
    """After the step, a leaf that no mesh axis splits holds the same bits
    on every rank, and a leaf that 'model' does not split the same bits
    across a 'data' row's ranks."""
    _, specs, _ = _layout(arch, shape)
    runs, _ = _runs(world, shape, arch)
    mesh = Sizes(data=shape[0], model=shape[1])
    for p, spec in specs.items():
        axes = {a for e in spec for a in (SH.norm_axes(e, mesh) or ())}
        if "model" in axes:
            continue
        for coord, run in runs:
            twin = [r for c, r in runs if c != coord and (
                not axes or c[0] == coord[0])]
            for other in twin:
                np.testing.assert_array_equal(run["params"][p],
                                              other["params"][p], err_msg=p)


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_each_rank_stores_its_spec_blocks_in_training(world, shape, arch):
    """Params, mu and nu are exactly each rank's blocks under
    ``param_specs(fsdp=True)``: their shapes and bytes."""
    mesh, specs, shapes = _layout(arch, shape)
    want = [tuple(n // SH.axis_size(mesh, SH.norm_axes(e, mesh) or ())
                  for n, e in zip(shapes[p], specs[p])) for p in shapes]
    nbytes = 4 * sum(int(np.prod(s)) for s in want)
    full = 4 * sum(int(np.prod(s)) for s in shapes.values())
    runs, _ = _runs(world, shape, arch)
    for _, run in runs:
        assert run["shapes"] == want
        assert run["bytes"] == {"params": nbytes, "mu": nbytes,
                                "nu": nbytes}
        assert nbytes < full / 2


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_train_step_is_the_references(world, shape, arch):
    """The reference's jitted train step on its 4-device mesh of the same
    shape: the loss within 1e-5 relative, the params after the step
    within the tolerance of one rank's."""
    mesh, specs, _ = _layout(arch, shape)
    ref = world[1][shape][arch]
    runs, one = _runs(world, shape, arch)
    for coord, run in runs:
        assert abs(run["step_loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        _hold_params(run["params"],
                     _blocks_of(ref["params"], specs, mesh, coord),
                     _blocks_of(one["grads"], specs, mesh, coord))


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_act_shard_policies_agree(world, shape, arch):
    """Remat on: 'model', 'seq' and 'none' give the same loss and
    gradients within 1e-6, and one rank's gradients within 1e-5·scale.
    Each save point keeps (rows, S, D/m) under 'model' and (rows, S/m, D)
    under 'seq', so the saved bytes fall by (1 - 1/m) of 'none''s save
    points, one a repeat."""
    m_size = shape[1]
    m = TC.get_reduced(arch)
    repeats = sum(seg.repeats for seg in m.segments)
    rows = TRAIN_BATCH // shape[0]
    d, s = m.d_model, TRAIN_SEQ
    point = rows * s * d * 4
    mesh, specs, _ = _layout(arch, shape)
    for r in range(WORLD):
        t = world[0][r][shape]["training"]
        coord = world[0][r][shape]["coord"]
        one = _blocks_of(world[0][0][shape]["training"][arch]["one"]["grads"],
                         specs, mesh, coord)
        runs = t[arch]["act_shard"]
        base = runs["none"]
        for policy, run in runs.items():
            assert abs(run["loss"] - base["loss"]) <= 1e-6
            for p, g in run["grads"].items():
                assert np.abs(g - base["grads"][p]).max() <= 1e-6, (policy,
                                                                    p)
                assert np.abs(g - one[p]).max() <= 1e-5 * _scale(one[p])
        total = {k: sum(b for _, b in v["saved"]) for k, v in runs.items()}
        kept = {"model": (rows, s, d // m_size),
                "seq": (rows, s // m_size, d)}
        for policy, blk in kept.items():
            assert sum(sh == blk for sh, _ in runs[policy]["saved"]) \
                == repeats
            assert total["none"] - total[policy] \
                == repeats * point * (m_size - 1) // m_size
        assert sum(sh == (rows, s, d) for sh, _ in
                   runs["none"]["saved"]) >= repeats


@pytest.mark.parametrize("micro", MICROBATCHES)
@pytest.mark.parametrize("shape", MODEL_MESHES, ids=MESH_IDS)
def test_microbatches_are_one_ranks(world, shape, micro):
    """2 and 4 microbatches: on (2, 2) a microbatch of 2 rows splits over
    'data', one of 1 row does not (every rank computes it whole)."""
    mesh, specs, _ = _layout("stablelm-1.6b", shape)
    for r in range(WORLD):
        run = world[0][r][shape]["training"]["micro"][micro]
        coord = world[0][r][shape]["coord"]
        assert abs(run["loss"] - run["one_loss"]) <= 1e-5 * run["one_loss"]
        want = _blocks_of(run["one_grads"], specs, mesh, coord)
        for p, w in want.items():
            assert np.abs(run["grads"][p] - w).max() \
                <= 1e-5 * _scale(run["one_grads"][p]), p


def _coll(world, key):
    return [(world[0][r][2, 2]["coord"], world[0][r]["collectives"][key])
            for r in range(WORLD)]


def test_f_and_g_pair(world):
    """y = Σ_r x·w_r (the row-parallel exit), loss = Σ y·c: the entered
    x's gradient is Σ_r w_r·c on every rank."""
    base = np.arange(8.0)
    for (_, mr), (y, gx) in _coll(world, "fg"):
        w_sum = 2 * base + 10
        np.testing.assert_array_equal(y, base * w_sum)
        np.testing.assert_array_equal(gx, w_sum * (base + 1))


def test_gather_sums_then_cuts(world):
    """A block gathered into rank-local work: its gradient is the sum of
    the ranks' gradients of the whole, cut to the block."""
    base = np.arange(8.0)
    for (_, mr), g in _coll(world, "gather_sum"):
        np.testing.assert_array_equal(g, (base * 3)[4 * mr:4 * mr + 4])


def test_gather_for_a_replicated_consumer_only_cuts(world):
    base = np.arange(8.0)
    for (_, mr), g in _coll(world, "gather_cut"):
        np.testing.assert_array_equal(g, (base + 1)[4 * mr:4 * mr + 4])


@pytest.mark.parametrize("split", [2, 1])
def test_fsdp_gather_backward(world, split):
    """FSDP's gather over 'data': with the rows split its backward is a
    reduce-scatter (each rank's rows differ); with every rank on the
    whole batch it only cuts (a sum there would count the batch twice)."""
    base = np.arange(8.0)
    for (dr, _), g in _coll(world, f"fsdp split {split}"):
        want = base * 3 if split > 1 else base
        np.testing.assert_array_equal(g, want[4 * dr:4 * dr + 4])


def test_save_point_block_and_gather(world):
    """A save point keeps the rank's block; gathered back at use, the
    stream's gradient is whole on every rank."""
    z = np.arange(8.0).reshape(2, 4) + 1
    for _, (shape, g) in _coll(world, "keep"):
        assert shape == (2, 2)
        np.testing.assert_array_equal(g, 2 * z)


def test_collectives_are_the_identity_on_one_rank():
    x = torch.arange(4.0, requires_grad=True)
    for y in (PAR.sum_over(x, None), PAR.enter_local(x, None),
              PAR.gather_dim(x, 0, None), PAR.keep_block(x, 0, None)):
        assert y is x


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b",
                                  "whisper-small"])
def test_other_archs_train_steps_raise(world, arch):
    """Their train steps build on a 'model' axis (ROADMAP Queue 1 item
    6c, done) and one step on the (2, 2) world (remat on, act_shard
    'model') gives one rank's loss within 1e-5 relative and every
    gradient block within 1e-4 of its leaf's norm, floored at 1e-4 of the
    whole gradient's (xlstm's b_i has none but rounding noise)."""
    step, _ = TS.make_train_step(TC.get_reduced(arch),
                                 mesh=Sizes(data=2, model=2))
    assert callable(step.loss_and_grads)
    mesh, specs, _ = _layout(arch, (2, 2))
    one = world[0][0]["other_archs"][arch]["one"]
    floor = 1e-4 * np.sqrt(sum(float(np.square(g).sum())
                               for g in one["grads"].values()))
    for r in range(WORLD):
        tr = world[0][r]["other_archs"][arch]["train"]
        assert abs(tr["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        coord = world[0][r][2, 2]["coord"]
        want = _blocks_of(one["grads"], specs, mesh, coord)
        for path, g in tr["grads"].items():
            norm = np.linalg.norm(one["grads"][path].ravel())
            assert np.linalg.norm((g - want[path]).ravel()) <= 1e-4 * max(
                norm, floor), path


def test_act_shard_is_checked():
    with pytest.raises(ValueError, match="act_shard"):
        TS.make_train_step(TC.get_reduced("stablelm-1.6b"),
                           act_shard="rows")
