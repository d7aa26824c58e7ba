"""The port on a 4-rank gloo world on the CPU, against one rank and the
reference's 4-device run.

The module starts 4 ranks once (``tests/_torch_ranks.py``, a ``FileStore``
under ``tmp_path``, one thread each); every rank builds ``make_host_mesh()``
= (data=4, model=1) and runs each scenario with no mesh and under it.
Beside them the reference runs ``explore_batch``, ``train_gan`` and reduced
mixtral on a 4-device host mesh in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``).

- Task sharding (the mirrors of the reference's ``tests/test_shard.py``
  multi-device tests and ``test_fused_mesh_parity``): ``explore_batch``
  at 8 and 6 tasks, ``select_batch``, the fused select, SA, DRL and
  LargeMLP at 6 tasks, and the serving stack's 5 submissions give the
  one-rank Selections bit for bit on every rank; the server pads its
  batch to the shard multiple.
- Data-parallel Algorithm 1: ``train_gan`` at batch 32 within rtol 2e-4 /
  atol 1e-6 of one rank (``loss_g`` within 1e-3), and at batch 30 (4 does
  not divide it) the one-rank bits.
- Against the reference's 4-device run: ``explore_batch``'s Selections at
  8 and 6 tasks bit for bit, and ``train_gan`` at batch 32 and 30 within
  the reference's tolerance.
- LM training: reduced stablelm's train step at B 4 and at B 8 in 2
  microbatches on 4 ranks against one rank; reduced mixtral's prefill
  and train step under the mesh against the reference's 4-device run at
  B 4 (the batch split, one token group a rank) and B 2 (not split: the
  reference's 4 groups inside each rank), and against one rank holding
  the same groups.
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 240

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs as C
from repro.core import gan as G
from repro.core import shard
from repro.core.dse_api import GANDSE
from repro.core.explorer import ExplorerConfig
from repro.core.train import train_gan
from repro.dataset.generator import generate_dataset, generate_tasks
from repro.design_models.im2col import Im2colModel
from repro.launch.mesh import make_host_mesh
from repro.models import base as MB
from repro.train import step as TS
sys.path.insert(0, sys.argv[2])
from _torch_ranks import (DSE_TASKS, MOE_BATCHES, TRAIN_RUNS, dse_cfg, flat,
                          moe_batch, sel)
mesh = make_host_mesh()
assert dict(mesh.shape) == {"data": 4, "model": 1}, mesh.shape
out = {}
model = Im2colModel()
eng = GANDSE(model, dse_cfg(G, model), ExplorerConfig(prob_threshold=0.1,
                                                      max_candidates=128))
eng.attach(generate_dataset(model, 256, seed=0), G.init_generator(
    jax.random.PRNGKey(3), dse_cfg(G, model), model.space))
with shard.task_mesh(mesh):
    for n in DSE_TASKS:
        out[f"explore {n}"] = [sel(r.selection) for r in eng.explore_batch(
            generate_tasks(model, n, seed=2), seed=7)]
    for bs, iters in TRAIN_RUNS:
        st = train_gan(model, generate_dataset(model, 128, seed=0),
                       dse_cfg(G, model, bs), iters=iters, seed=0)
        out[f"train {bs}"] = (flat(jax.tree.map(np.asarray, {
            "g": st.g_params, "d": st.d_params})),
            [h["loss_g"] for h in st.history])
m = C.get_reduced("mixtral-8x7b")
params = MB.init_params(jax.random.PRNGKey(0), m)
for b in MOE_BATCHES:
    toks, labels = moe_batch(b, m.vocab)
    tok = jnp.asarray(toks, jnp.int32)
    out[f"logits {b}"] = np.asarray(
        jax.jit(TS.make_prefill_step(m, mesh=mesh))(params, {"tokens": tok}))
    out[f"logits nomesh {b}"] = np.asarray(
        jax.jit(TS.make_prefill_step(m))(params, {"tokens": tok}))
    step, optim = TS.make_train_step(m, lr=1e-3, remat=False, mesh=mesh)
    p, _, met = jax.jit(step)(params, optim.init(params), {
        "tokens": tok, "labels": jnp.asarray(labels, jnp.int32)})
    out[f"loss {b}"] = np.asarray(met["loss"])
    for k, v in flat(jax.tree.map(np.asarray, p)).items():
        out[f"p {b} {k}"] = v
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _env(**extra):
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{rank: what it saw}, and the reference's 4-device arrays."""
    tmp = tmp_path_factory.mktemp("ranks")
    ref_out = tmp / "reference.pkl"
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref_out), str(ROOT / "tests")],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_ranks.py"), str(r),
         str(WORLD), str(tmp / "store"), str(tmp)],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.time() + TIMEOUT_S
    logs = []
    try:
        for p in ranks + [ref]:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            logs.append(out.decode(errors="replace")[-4000:])
    finally:
        for p in ranks + [ref]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(ranks + [ref], logs):
        assert p.returncode == 0, log
    seen = {}
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            seen[r] = pickle.load(f)
        assert "error" not in seen[r], seen[r]["error"]
    with open(ref_out, "rb") as f:
        reference = pickle.load(f)
    return seen, reference


def _each_rank(world, key):
    seen, _ = world
    return [seen[r][key] for r in range(WORLD)]


def test_every_rank_builds_the_host_mesh(world):
    for r in range(WORLD):
        assert world[0][r]["mesh"] == ((4, 1), ("data", "model"))
        assert world[0][r]["n_shards"] == 4


@pytest.mark.parametrize("key", ["explore 8", "explore 6", "select_batch",
                                 "fused_select", "SA", "DRL", "LargeMLP"])
def test_task_sharded_selections_are_one_ranks(world, key):
    """Bit for bit: the cfg rows, the float64 metrics, the flags and the
    candidate counts, on every rank."""
    for base, sharded, gathers in _each_rank(world, key):
        assert sharded == base, key
        assert len(base) in (6, 8)
        assert gathers == 1     # one shard-and-gather, not nested


def test_server_under_mesh_matches_and_pads_to_the_shard_multiple(world):
    for (base, _, _, _), (sharded, padded, in_mesh, after) in \
            _each_rank(world, "serve"):
        assert sharded == base
        # 5 requests -> one 8-row batch under the 4-way mesh
        assert padded == 3
        assert in_mesh == {"n_shards": 4, "mesh": {"data": 4, "model": 1},
                           "task_axes": ("data",)}
        assert after["n_shards"] == 1 and after["mesh"] is None


@pytest.mark.parametrize("n", [8, 6])
def test_task_sharded_selections_are_the_references(world, n):
    """Every rank's sharded Selections are the reference's 4-device
    run's, bit for bit."""
    _, ref = world
    for _, sharded, _ in _each_rank(world, f"explore {n}"):
        assert sharded == ref[f"explore {n}"]


def test_train_gan_data_parallel_matches_one_rank(world):
    """The reference's own tolerance (tests/test_shard.py): rtol 2e-4,
    atol 1e-6 on the params, loss_g within 1e-3; every rank holds the
    same params."""
    runs = _each_rank(world, "train 32")
    for (base, base_hist), (sharded, hist) in runs:
        assert sharded.keys() == base.keys()
        for k, a in base.items():
            np.testing.assert_allclose(sharded[k], a, rtol=2e-4, atol=1e-6,
                                       err_msg=k)
        assert len(hist) == len(base_hist) == 8
        assert max(abs(x - y) for x, y in zip(hist, base_hist)) < 1e-3
    for (_, (params, _)) in runs[1:]:
        for k, a in runs[0][1][0].items():
            np.testing.assert_array_equal(params[k], a, err_msg=k)


def test_train_gan_falls_back_when_the_batch_does_not_divide(world):
    for (base, base_hist), (sharded, hist) in _each_rank(world, "train 30"):
        for k, a in base.items():
            np.testing.assert_array_equal(sharded[k], a, err_msg=k)
        assert hist == base_hist


@pytest.mark.parametrize("bs", [32, 30])
def test_train_gan_under_the_mesh_matches_the_references(world, bs):
    """Every rank's run under the mesh against the reference's 4-device
    run (data parallel at batch 32, the fallback at 30): the params within
    the reference's tolerance, rtol 2e-4 / atol 1e-6, loss_g within
    1e-3."""
    _, ref = world
    want, want_hist = ref[f"train {bs}"]
    for _, (params, hist) in _each_rank(world, f"train {bs}"):
        assert params.keys() == want.keys()
        for k, a in want.items():
            np.testing.assert_allclose(params[k], a, rtol=2e-4, atol=1e-6,
                                       err_msg=k)
        assert len(hist) == len(want_hist)
        assert max(abs(x - y) for x, y in zip(hist, want_hist)) < 1e-3


@pytest.mark.parametrize("key", ["stablelm 4x1", "stablelm 8x2"])
def test_lm_train_step_data_parallel_matches_one_rank(world, key):
    """Two AdamW steps on 4 ranks (each rank's rows of every microbatch)
    against one rank: losses and every param."""
    for (base, base_losses), (sharded, losses) in _each_rank(world, key):
        np.testing.assert_allclose(losses, base_losses, rtol=1e-5)
        for a, b in zip(base, sharded):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b", [4, 2])
def test_moe_groups_match_the_reference_four_device_run(world, b):
    """Reduced mixtral under the (4, 1) mesh: the prefill logits, the
    first train step's loss and every updated param are the reference's
    4-device run's, at B 4 (split: one group a rank) and B 2 (the 4
    groups inside every rank).  The groups matter: the reference's logits
    without the mesh are further from its own."""
    _, ref = world
    for logits, loss, params in _each_rank(world, f"mixtral {b}"):
        np.testing.assert_allclose(logits, ref[f"logits {b}"],
                                   rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(loss, ref[f"loss {b}"], rtol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(v, ref[f"p {b} {k}"], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    diff = np.abs(ref[f"logits nomesh {b}"] - ref[f"logits {b}"]).max()
    assert diff > 10 * np.abs(logits - ref[f"logits {b}"]).max()


@pytest.mark.parametrize("b", [4, 2])
def test_moe_forward_on_four_ranks_is_one_ranks(world, b):
    """One rank holding the same 4 groups (a (4, 1) mesh in the context,
    no split) gives the 4 ranks' prefill logits."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_ranks import moe_batch

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models import base as MB
    from repro_torch.train import step as TS

    class FourRanks:
        shape = {"data": 4, "model": 1}

    m = configs.get_reduced("mixtral-8x7b")
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    toks, _ = moe_batch(b, m.vocab)
    one = TS.make_prefill_step(m, mesh=FourRanks())(
        params, {"tokens": torch.from_numpy(toks)}).numpy()
    for logits, _, _ in _each_rank(world, f"mixtral {b}"):
        np.testing.assert_allclose(logits, one, rtol=1e-5, atol=1e-6)
