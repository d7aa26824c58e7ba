"""Serving and the DSE task mesh across a 'model' axis, on a 4-rank gloo
world on the CPU, against one rank and the reference's 4-device run.

The module starts 4 ranks once (``tests/_torch_ranks.py ... model``, a
``FileStore`` under ``tmp_path``, one thread each); every rank builds the
(1, 4) and (2, 2) ('data', 'model') meshes and on each:

- shards reduced stablelm (MHA), qwen3 (GQA), gemma3 (one KV head, the
  ring) and mixtral (E = 4: expert parallel on both meshes) by
  ``param_specs(fsdp=True)`` and their Engine's decode states by
  ``state_specs``: each rank's blocks have the specs' shapes and bytes;
- runs the prefill step on its blocks: the logits within 1e-5·max(1,
  max|logit|) of one rank holding the whole params (in the same MoE token
  groups), the same on every rank;
- serves 4 requests for 8 ``Engine`` steps: one rank's tokens;
- decodes gemma3's windowed layer past rings of 16 slots (S over
  'model': the ranks' partial softmaxes combined) and of 8 (dh over
  'model': the block gathered at use);
- runs ``moe_apply_sharded`` on the reference's expert-parallel test's
  layer.

On the (2, 2) task mesh ``explore_batch`` gives one rank's Selections bit
for bit and ``train_gan`` at batch 32 stays within the reference's
tolerance.  Beside them the reference runs the same prefills and its
``moe_apply`` on its 4-device meshes in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``): the port's
logits and layer within 1e-4 of them.  On (2, 2) the ranks also serve
and train reduced hymba, xlstm and whisper once against one rank (their
parity in full is ``tests/test_torch_model_axis_recurrent.py``'s);
training there is ``tests/test_torch_model_axis_train.py``'s.

The ranks alone:
``for r in 0 1 2 3; do PYTHONPATH=src python tests/_torch_ranks.py $r 4
DIR/store DIR model & done; wait``.
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
from repro_torch.launch.serve import Engine, Request
from repro_torch.models import base as MB
from repro_torch.optim import tree_leaves
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_ranks import (ENGINE, MODEL_ARCHS, MODEL_MESHES,  # noqa: E402
                          OTHER_ARCHS, RING_CACHES, Sizes)

WORLD = 4
TIMEOUT_S = 240

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs as C
from repro.launch.mesh import make_host_mesh
from repro.models import base as MB
from repro.nn import moe as M
from repro.train import shardings as SH
from repro.train import step as TS
sys.path.insert(0, sys.argv[2])
from _torch_ranks import MODEL_ARCHS, MODEL_MESHES, model_tokens
out = {}
for shape in MODEL_MESHES:
    mesh = make_host_mesh(shape)
    for arch in MODEL_ARCHS:
        m = C.get_reduced(arch)
        params = MB.init_params(jax.random.PRNGKey(0), m)
        tok = jnp.asarray(model_tokens(m.vocab), jnp.int32)
        out[shape, arch] = np.asarray(jax.jit(TS.make_prefill_step(
            m, mesh=mesh))(params, {"tokens": tok}))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(32, 16)),
                    jnp.float32)
    p = M.moe_init(jax.random.PRNGKey(0), 4, 16, 32)
    with mesh, SH.use_mesh(mesh):
        out[shape, "moe"] = np.asarray(jax.jit(lambda p, x: M.moe_apply(
            p, x, top_k=2, capacity_factor=8.0))(p, x))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

CASES = [(shape, arch) for shape in MODEL_MESHES for arch in MODEL_ARCHS]
IDS = [f"{a}x{b}-{arch}" for (a, b), arch in CASES]


def _env(**extra):
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{rank: what it saw}, and the reference's 4-device arrays."""
    tmp = tmp_path_factory.mktemp("model_ranks")
    ref_out = tmp / "reference.pkl"
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref_out), str(ROOT / "tests")],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_ranks.py"), str(r),
         str(WORLD), str(tmp / "store"), str(tmp), "model"],
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


def _served(world, shape, arch):
    return [world[0][r][shape]["serving"][arch] for r in range(WORLD)]


def _scale(a) -> float:
    return max(1.0, float(np.abs(a).max()))


def _blocks(tree, specs, mesh) -> list:
    """Each leaf's block shape under its spec: its dims cut by the sizes of
    the axes that shard them."""
    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    flat = []

    def walk(s):
        if isinstance(s, SH.P):
            flat.append(s)
        elif isinstance(s, dict):
            for v in s.values():
                walk(v)
        elif isinstance(s, (list, tuple)):
            for v in s:
                walk(v)

    walk(specs)
    assert len(flat) == len(leaves)
    return [tuple(n // SH.axis_size(mesh, SH.norm_axes(e, mesh) or ())
                  for n, e in zip(t.shape, spec))
            for t, spec in zip(leaves, flat)]


def _nbytes(shapes) -> int:
    return 4 * sum(int(np.prod(s)) for s in shapes)


@pytest.mark.parametrize("shape", MODEL_MESHES)
def test_every_rank_sits_on_its_coordinate(world, shape):
    coords = [world[0][r][shape]["coord"] for r in range(WORLD)]
    assert coords == [divmod(r, shape[1]) for r in range(WORLD)]


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_each_rank_stores_its_spec_blocks(world, shape, arch):
    """The params of the prefill and of the Engine, and the Engine's
    decode states, are exactly each rank's blocks under
    ``param_specs(fsdp=True)`` and ``state_specs``: their shapes and
    bytes."""
    mesh = Sizes(data=shape[0], model=shape[1])
    m = TC.get_reduced(arch)
    structs = MB.init_params(prng.prng_key(torch.tensor(0)), m,
                             torch.device("meta"))
    want = _blocks(structs, SH.param_specs(structs, mesh), mesh)
    states = MB.init_decode_state(structs, m, ENGINE["slots"],
                                  ENGINE["cache_len"])
    want_states = _blocks(states, SH.state_specs(states, mesh,
                                                 ENGINE["slots"]), mesh)
    full = 4 * sum(t.numel() for t in tree_leaves(structs))
    assert len(want) == len(tree_leaves(structs))
    for seen in _served(world, shape, arch):
        assert seen["shapes"] == want
        assert seen["param_bytes"] == seen["engine_param_bytes"] \
            == _nbytes(want)
        assert seen["state_bytes"] == _nbytes(want_states)
        assert seen["param_bytes"] < full / 2
        # every leaf gathered back over the mesh is the full leaf
        assert len(seen["gathered_whole"]) == len(want)
        assert all(seen["gathered_whole"])


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_prefill_on_the_blocks_is_one_ranks(world, shape, arch):
    runs = _served(world, shape, arch)
    for seen in runs:
        want = seen["one_logits"]
        assert seen["logits"].shape == want.shape == (4, 512)
        assert np.abs(seen["logits"] - want).max() <= 1e-5 * _scale(want)
        np.testing.assert_array_equal(seen["logits"], runs[0]["logits"])


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_prefill_on_the_blocks_is_the_references(world, shape, arch):
    """Within 1e-4 of the reference's prefill on its 4-device mesh of the
    same shape (its MoE groups are the mesh's batch axes, as here)."""
    want = world[1][shape, arch]
    for seen in _served(world, shape, arch):
        np.testing.assert_allclose(seen["logits"], want, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_engine_on_the_blocks_gives_one_ranks_tokens(world, shape, arch):
    for seen in _served(world, shape, arch):
        assert seen["iters"] == 8
        assert seen["tokens"] == seen["one_tokens"]
        assert sorted(seen["tokens"]) == list(range(ENGINE["requests"]))
        assert all(len(t) == ENGINE["max_new"]
                   for t in seen["tokens"].values())


@pytest.mark.parametrize("shape", MODEL_MESHES)
@pytest.mark.parametrize("cache", RING_CACHES)
def test_decode_past_the_ring_is_one_ranks(world, shape, cache):
    """gemma3's windowed layer decoded past its ring: with 16 slots the
    cache's S is split over 'model' (each rank attends its block and the
    partial softmaxes combine), with 8 its dh (the larger dim there)."""
    m = shape[1]
    b = 2 // shape[0]
    want_kv = (1, b, cache // m, 1, 16) if cache == 16 \
        else (1, b, cache, 1, 16 // m)
    for r in range(WORLD):
        ring = world[0][r][shape]["serving"]["ring"]
        assert ring[cache, "kv_shape"] == want_kv
        want = ring[cache, False]
        assert np.abs(ring[cache, True] - want).max() <= 1e-5 * _scale(want)


@pytest.mark.parametrize("shape", MODEL_MESHES)
def test_moe_expert_parallel_layer_is_the_references(world, shape):
    """The reference's own tolerance (``tests/test_distribution.py``):
    rtol and atol 1e-4, every rank the same bits."""
    want = world[1][shape, "moe"]
    got = [world[0][r][shape]["moe_layer"] for r in range(WORLD)]
    for y, one, w_gate in got:
        assert w_gate == (4 // shape[1], 16, 32 // shape[0])
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
        assert np.abs(y - one).max() <= 1e-5 * _scale(one)
        np.testing.assert_array_equal(y, got[0][0])


@pytest.mark.parametrize("shape", MODEL_MESHES)
def test_moe_layer_where_model_does_not_divide_e(world, shape):
    """E = 6: on (1, 4) each rank holds every expert's F/4 block and the
    ranks sum their partial outputs; on (2, 2) 3 experts a rank."""
    want_gate = (6, 16, 8) if shape == (1, 4) else (3, 16, 16)
    for r in range(WORLD):
        y, one, w_gate = world[0][r][shape]["moe_layer_6"]
        assert w_gate == want_gate
        assert np.abs(y - one).max() <= 1e-5 * _scale(one)


@pytest.mark.parametrize("shape", MODEL_MESHES)
def test_prefill_where_model_does_not_divide_the_heads(world, shape):
    """6 heads: on (1, 4) 'model' splits wq's columns mid-head, so every
    rank forms all 6 heads and takes its rows of ``wo``; on (2, 2) 3
    heads a rank."""
    for r in range(WORLD):
        got, want = world[0][r][shape]["heads_6"]
        assert np.abs(got - want).max() <= 1e-5 * _scale(want)


def test_task_mesh_selections_are_one_ranks(world):
    """(2, 2): the tasks split over 'data', the two ranks of a 'model'
    group compute the same rows; one gather."""
    for r in range(WORLD):
        base, sharded, gathers = world[0][r]["dse"]["explore"]
        assert sharded == base and len(base) == 8
        assert gathers == 1


def test_train_gan_on_the_task_mesh_matches_one_rank(world):
    """The reference's tolerance (tests/test_shard.py): rtol 2e-4, atol
    1e-6 on the params, loss_g within 1e-3; every rank the same bits."""
    runs = [world[0][r]["dse"]["train"] for r in range(WORLD)]
    for (base, base_hist), (sharded, hist) in runs:
        for k, a in base.items():
            np.testing.assert_allclose(sharded[k], a, rtol=2e-4, atol=1e-6,
                                       err_msg=k)
        assert max(abs(x - y) for x, y in zip(hist, base_hist)) < 1e-3
    for _, (params, _) in runs[1:]:
        for k, a in runs[0][1][0].items():
            np.testing.assert_array_equal(params[k], a, err_msg=k)


def test_batch_axes_plane_group(world):
    """(pod 2, data 2, model 1): the ('pod', 'data') plane's group is the
    4 ranks in row-major order; an axis of size 1 has no group."""
    for r in range(WORLD):
        coord, gathered, model = world[0][r]["plane"]
        assert coord == r and gathered == [0, 1, 2, 3]
        assert model == (None, 0)


MESH22 = Sizes(data=2, model=2)


class Mesh3:
    shape = {"pod": 2, "data": 2, "model": 2}


def test_local_blocks_tile_the_leaf():
    """Every coordinate's ``local_block`` of a leaf split over ('pod',
    'data') (row-major) and 'model' tiles the leaf once."""
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    spec = SH.P(("pod", "data"), "model")
    seen = torch.zeros_like(t)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                blk = SH.local_block(t, spec, Mesh3(),
                                     dict(pod=pod, data=data, model=model))
                i, j = 2 * pod + data, model
                np.testing.assert_array_equal(
                    blk, t[2 * i:2 * i + 2, 3 * j:3 * j + 3])
                seen[2 * i:2 * i + 2, 3 * j:3 * j + 3] += 1
    assert bool((seen == 1).all())
    assert SH.block_of(None, Mesh3(), dict(pod=1, data=1, model=1)) == (0, 1)


@pytest.mark.parametrize("ring,start", [(False, False), (False, True),
                                        (True, False), (True, True)])
def test_cache_blocks_combine_to_the_whole_cache(ring, start):
    """``decode_attention_block`` over the blocks of a cache, combined by
    the online-softmax rule (``combine_blocks``' arithmetic), is
    ``decode_attention`` over the whole cache, with a ring and the
    per-lane stale mask; a block that reads no slot adds nothing."""
    from repro_torch.nn import attention as A

    g = torch.Generator().manual_seed(0)
    b, sc, hkv, grp, d = 2, 16, 2, 2, 8
    q = torch.randn(b, 1, hkv * grp, d, generator=g)
    k, v = (torch.randn(b, sc, hkv, d, generator=g) for _ in range(2))
    cache_len = 21 if ring else 11
    kw = dict(window=16 if ring else None, ring=ring,
              start=torch.tensor([0, 7 if ring else 4]) if start else None)
    want = A.decode_attention(q, k, v, cache_len, **kw)
    parts = [A.decode_attention_block(q, k[:, i:i + 4], v[:, i:i + 4],
                                      cache_len, sc=sc, slot0=i, **kw)
             for i in range(0, sc, 4)]
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(o * torch.exp(m - big)[..., None] for m, _, o in parts)
    den = sum(l * torch.exp(m - big) for m, l, _ in parts)
    got = (num / den[..., None]).reshape(b, 1, hkv * grp, d)
    if not ring:            # slots 12-15 lie past the 11 cached tokens
        assert bool((parts[-1][0] == -1e30).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_training_on_a_model_axis_raises(world):
    """Training there (``tests/test_torch_model_axis_train.py``,
    ``tests/test_torch_model_axis_recurrent.py``) builds for every ported
    arch: the dense and MoE decoders and hymba, xlstm and whisper (ROADMAP
    Queue 1 item 6c, done); on the (2, 2) world one train step of each of
    the last three gives one rank's loss within 1e-5."""
    for arch in ("stablelm-1.6b",) + OTHER_ARCHS:
        step, _ = TS.make_train_step(TC.get_reduced(arch), mesh=MESH22)
        assert callable(step) and callable(step.loss_and_grads)
    for arch in OTHER_ARCHS:
        want = world[0][0]["other_archs"][arch]["one"]["loss"]
        for r in range(WORLD):
            got = world[0][r]["other_archs"][arch]["train"]
            assert abs(got["loss"] - want) <= 1e-5 * abs(want)
            assert abs(got["step_loss"] - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b",
                                  "whisper-small"])
def test_other_archs_on_a_model_axis_raise(world, arch):
    """Their prefill and decode steps build on a 'model' axis and run on
    the (2, 2) world: one rank's prefill logits within 1e-5·max(1,
    max|logit|), hymba's and xlstm's ``Engine`` one rank's tokens,
    whisper's decode steps one rank's logits.  Whisper's ``Engine`` passes
    no encoder output and fails at its first step there as on one rank
    (the reference's, ROADMAP Queue 3 item 7)."""
    m = TC.get_reduced(arch)
    assert callable(TS.make_prefill_step(m, mesh=MESH22))
    assert callable(TS.make_decode_step(m, mesh=MESH22, cache_len=16))
    for r in range(WORLD):
        seen = world[0][r]["other_archs"][arch]
        want = seen["one_logits"]
        assert np.abs(seen["logits"] - want).max() <= 1e-5 * _scale(want)
        if m.enc_segments is None:
            assert seen["iters"] == 8
            assert seen["tokens"] == seen["one_tokens"]
            continue
        want = seen["one_decode"]
        assert np.abs(seen["decode"] - want).max() <= 1e-5 * _scale(want)
        assert "enc_out" in seen["engine_error"]
    if m.enc_segments is not None:
        params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
        eng = Engine(m, params, 2, 16, device="cpu")
        eng.submit(Request(rid=0, prompt=[1, 2], max_new=2))
        with pytest.raises(ValueError, match="enc_out"):
            eng.step()
