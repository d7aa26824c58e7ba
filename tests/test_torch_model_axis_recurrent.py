"""Hymba, xlstm and whisper across a 'model' axis, served and trained on a
4-rank gloo world on the CPU, against one rank and the reference's
4-device prefill.

The module starts 4 ranks once (``tests/_torch_ranks.py ... recurrent``,
a ``FileStore`` under ``tmp_path``, one thread each); every rank builds
the (1, 4) and (2, 2) ('data', 'model') meshes and on each, for reduced
hymba (4 heads, 2 KV heads), hymba with 5 heads and one KV head (which 2
and 4 do not divide), reduced xlstm (4 heads), xlstm with 2 heads (which
4 does not divide) and reduced whisper:

- shards the params by ``param_specs(fsdp=True)`` and the decode states
  by ``state_specs``: each rank keeps exactly its blocks' shapes and
  bytes;
- runs the prefill on its blocks (whisper's with 32 frames): the logits
  within 1e-5·max(1, max|logit|) of one rank's, the same bits on every
  rank, and within 1e-4·max(1, max|logit|) of the reference's 4-device
  ``make_prefill_step`` on the same mesh shape;
- serves 4 requests for 8 ``Engine`` steps (hymba, xlstm): one rank's
  tokens; whisper decodes 8 ``make_decode_step`` steps after one
  ``encode``: one rank's logits;
- takes one train step (remat on, act_shard 'model'): the loss within
  1e-5 relative of one rank's, every gradient block within 1e-4 of its
  leaf's norm, params, mu and nu exactly the spec blocks' bytes.

On (2, 2) every rank also decodes one lane of a hymba and an xlstm wide
enough that ``state_spec`` puts 'data' on their recurrent states' Di
and D: its logits and new states against one rank's.

The layouts a naive port gets wrong each have a case: ``in_proj``'s x | z
and ``wqkv``'s q | k | v columns, heads that 'model' does not divide,
whisper's layer-owned GEGLU FFN, xlstm's blocked decode state, whisper's
replicated table, and the sLSTM's recurrence, which couples every head
to every channel.

The ranks alone:
``for r in 0 1 2 3; do PYTHONPATH=src python tests/_torch_ranks.py $r 4
DIR/store DIR recurrent & done; wait``.
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
from repro_torch.models import builders as TB
from repro_torch.nn import blocks as B
from repro_torch.optim import tree_leaves
from repro_torch.train import parallel as PAR
from repro_torch.train import shardings as SH

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_ranks import (ENGINE, MODEL_BATCH, MODEL_MESHES,  # noqa: E402
                          REC_CACHE, REC_STEPS, RECURRENT_ARCHS, WIDE_ARCHS,
                          WIDE_STEPS, Sizes, recurrent_config, wide_config)

WORLD = 4
TIMEOUT_S = 240

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs as C
from repro.launch.mesh import make_host_mesh
from repro.models import base as MB
from repro.models import builders
from repro.train import step as TS
sys.path.insert(0, sys.argv[2])
from _torch_ranks import (MODEL_MESHES, RECURRENT_ARCHS, rec_batch,
                          recurrent_config)
out = {}
for shape in MODEL_MESHES:
    mesh = make_host_mesh(shape)
    for arch in RECURRENT_ARCHS:
        m = recurrent_config(C, builders, arch)
        params = MB.init_params(jax.random.PRNGKey(0), m)
        batch = rec_batch(m)
        del batch["labels"]
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        batch["tokens"] = batch["tokens"].astype(jnp.int32)
        out[shape, arch] = np.asarray(jax.jit(TS.make_prefill_step(
            m, mesh=mesh))(params, batch))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

CASES = [(shape, arch) for shape in MODEL_MESHES for arch in RECURRENT_ARCHS]
IDS = [f"{a}x{b}-{arch}" for (a, b), arch in CASES]


def _env(**extra):
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{rank: what it saw}, and the reference's 4-device prefills."""
    tmp = tmp_path_factory.mktemp("recurrent_ranks")
    ref_out = tmp / "reference.pkl"
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref_out), str(ROOT / "tests")],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_ranks.py"), str(r),
         str(WORLD), str(tmp / "store"), str(tmp), "recurrent"],
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


def _runs(world, shape, arch) -> list:
    return [world[0][r][shape]["runs"][arch] for r in range(WORLD)]


def _scale(a) -> float:
    return max(1.0, float(np.abs(a).max()))


def _config(arch):
    return recurrent_config(TC, TB, arch)


def _structs(m):
    return MB.init_params(prng.prng_key(torch.tensor(0)), m,
                          torch.device("meta"))


def _spec_list(specs) -> list:
    """A spec tree's ``P``s (a state's ``len`` ints dropped)."""
    if isinstance(specs, SH.P):
        return [specs]
    if isinstance(specs, int):
        return []
    if isinstance(specs, dict):
        return [p for v in specs.values() for p in _spec_list(v)]
    return [p for v in specs for p in _spec_list(v)]


def _blocks(tree, specs, mesh) -> list:
    """Each tensor leaf's block shape under its spec."""
    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    flat = _spec_list(specs)
    assert len(flat) == len(leaves)
    return [tuple(n // SH.axis_size(mesh, SH.norm_axes(e, mesh) or ())
                  for n, e in zip(t.shape, spec))
            for t, spec in zip(leaves, flat)]


def _nbytes(shapes) -> int:
    return 4 * sum(int(np.prod(s)) for s in shapes)


def _flat_specs(specs, path=()) -> dict:
    """{"a/b/0/c": P}, the paths of ``_torch_ranks.flat``."""
    if isinstance(specs, SH.P):
        return {"/".join(path): specs}
    if isinstance(specs, dict):
        return {k: v for key in specs
                for k, v in _flat_specs(specs[key], path + (key,)).items()}
    return {k: v for i, s in enumerate(specs)
            for k, v in _flat_specs(s, path + (str(i),)).items()}


@pytest.mark.parametrize("shape", MODEL_MESHES)
def test_every_rank_sits_on_its_coordinate(world, shape):
    coords = [world[0][r][shape]["coord"] for r in range(WORLD)]
    assert coords == [divmod(r, shape[1]) for r in range(WORLD)]


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_each_rank_stores_its_spec_blocks(world, shape, arch):
    """The params (and Adam's moments after the step) are exactly each
    rank's blocks under ``param_specs(fsdp=True)``, the decode states
    under ``state_specs``: their shapes and bytes."""
    mesh = Sizes(data=shape[0], model=shape[1])
    m = _config(arch)
    structs = _structs(m)
    want = _blocks(structs, SH.param_specs(structs, mesh), mesh)
    slots, cache = ((MODEL_BATCH, REC_CACHE) if m.enc_segments is not None
                    else (ENGINE["slots"], ENGINE["cache_len"]))
    states = MB.init_decode_state(structs, m, slots, cache)
    want_states = _blocks(states, SH.state_specs(states, mesh, slots), mesh)
    for seen in _runs(world, shape, arch):
        assert seen["shapes"] == want
        assert seen["param_bytes"] == _nbytes(want)
        assert seen["state_bytes"] == _nbytes(want_states)
        tr = seen["train"]
        assert tr["shapes"] == want
        assert tr["bytes"] == dict(params=_nbytes(want), mu=_nbytes(want),
                                   nu=_nbytes(want))


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_prefill_on_the_blocks_is_one_ranks(world, shape, arch):
    runs = _runs(world, shape, arch)
    for seen in runs:
        want = seen["one_logits"]
        assert seen["logits"].shape == want.shape == (MODEL_BATCH, 512)
        assert np.isfinite(seen["logits"]).all()
        assert np.abs(seen["logits"] - want).max() <= 1e-5 * _scale(want)
        np.testing.assert_array_equal(seen["logits"], runs[0]["logits"])


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_prefill_on_the_blocks_is_the_references(world, shape, arch):
    """Within 1e-4·max(1, max|logit|) of the reference's prefill on its
    4-device mesh of the same shape."""
    want = world[1][shape, arch]
    for seen in _runs(world, shape, arch):
        assert np.abs(seen["logits"] - want).max() <= 1e-4 * _scale(want)


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_serving_on_the_blocks_is_one_ranks(world, shape, arch):
    """hymba and xlstm: 8 ``Engine`` steps give one rank's tokens (each
    admitted lane's recurrent state reset on the rank that holds it);
    whisper: 8 decode steps after one ``encode`` give one rank's logits
    within 1e-5·max(1, max|logit|)."""
    for seen in _runs(world, shape, arch):
        if "decode" in seen:
            want = seen["one_decode"]
            assert seen["decode"].shape == want.shape == (MODEL_BATCH,
                                                          REC_STEPS, 512)
            assert np.abs(seen["decode"] - want).max() <= 1e-5 * _scale(want)
            continue
        assert seen["iters"] == 8
        assert seen["tokens"] == seen["one_tokens"]
        assert all(len(t) == ENGINE["max_new"]
                   for t in seen["tokens"].values())


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_train_step_on_the_blocks_is_one_ranks(world, shape, arch):
    """One step with remat on and act_shard 'model': the loss within 1e-5
    relative of the world of one's, the step's own loss the same, every
    gradient block before the clip within 1e-4 of its leaf's norm (floored
    at 1e-4 of the whole gradient's norm: the mLSTM's b_i has a gradient
    of 0 in exact arithmetic, the stabiliser absorbing a shift of every
    input gate, so its float32 gradient is rounding noise), the clip scale
    within 1e-5."""
    mesh = Sizes(data=shape[0], model=shape[1])
    specs = _flat_specs(SH.param_specs(_structs(_config(arch)), mesh))
    one = world[0][0][shape]["runs"][arch]["one"]
    floor = 1e-4 * np.sqrt(sum(float(np.square(g).sum())
                               for g in one["grads"].values()))
    for r in range(WORLD):
        coord = dict(zip(("data", "model"), world[0][r][shape]["coord"]))
        tr = world[0][r][shape]["runs"][arch]["train"]
        assert abs(tr["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert abs(tr["step_loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert abs(tr["scale"] - one["scale"]) <= 1e-5
        assert tr["grads"].keys() == one["grads"].keys()
        for path, full in one["grads"].items():
            want = SH.local_block(torch.from_numpy(full), specs[path], mesh,
                                  coord).numpy()
            err = np.linalg.norm((tr["grads"][path] - want).ravel())
            assert err <= 1e-4 * max(np.linalg.norm(full.ravel()), floor), \
                path


def test_in_proj_and_wqkv_blocks_are_not_channel_or_head_blocks(world):
    """At 'model' 2 a rank's block of hymba's ``in_proj`` (x then z
    columns) is all of x or all of z, and of xlstm's ``wqkv`` (q, k, v)
    q and half of k: neither is the rank's channels or heads, so each
    rank gathers the columns and picks its own (``PAR.column_blocks``);
    the prefills on (2, 2) hold to one rank's."""
    mesh = Sizes(data=1, model=2)
    for arch, path, width in (("hymba-1.5b", ("ssm", "in_proj"), 128),
                              ("xlstm-1.3b", ("wqkv",), 64)):
        m = _config(arch)
        structs = _structs(m)
        leaf = structs["segments"][0][0]
        spec = SH.param_specs(structs, mesh)["segments"][0][0]
        for k in path:
            leaf, spec = leaf[k], spec[k]
        full = torch.arange(leaf.shape[-1])
        blocks = [SH.local_block(full, SH.P(spec[-1]), mesh,
                                 dict(data=0, model=r)) for r in range(2)]
        parts = leaf.shape[-1] // width
        assert [b.tolist() for b in blocks] == [
            full[:parts * width // 2].tolist(),
            full[parts * width // 2:].tolist()]
        # the rank's own columns: its half of every part
        mine = [torch.cat([full[p * width + r * width // 2:
                                p * width + (r + 1) * width // 2]
                           for p in range(parts)]) for r in range(2)]
        assert not any(torch.equal(a, b) for a, b in zip(blocks, mine))
        for seen in _runs(world, (2, 2), arch):
            want = seen["one_logits"]
            assert np.abs(seen["logits"] - want).max() <= 1e-5 * _scale(want)


@pytest.mark.parametrize("shape", MODEL_MESHES)
def test_heads_that_model_does_not_divide(world, shape):
    """hymba with 5 heads (as hymba-1.5b's 25 at 'model' 2): every rank's
    attention runs all 5 heads and takes ``wo``'s rows, which end
    mid-head; reduced hymba's 4 heads run H/m a rank.  xlstm with 2 heads
    at 'model' 4 runs every mLSTM head on every rank from the gathered
    weights (``nn/xlstm._mlstm_replicated``); its prefill, Engine and
    train step are held above."""
    for r in range(WORLD):
        runs = world[0][r][shape]["runs"]
        assert runs["hymba-5-heads"]["heads"] == [5]
        assert runs["hymba-1.5b"]["heads"] == [4 // shape[1]]
        assert runs["whisper-small"]["heads"] == [4 // shape[1]]
        assert runs["xlstm-1.3b"]["heads"] == []
        assert runs["xlstm-2-heads"]["heads"] == []


def test_whisper_ffn_is_the_geglu_on_every_layout(world):
    """Whisper's FFN across 'model' keeps its GEGLU (tanh gelu): the
    layer-owned stacks (2 layers at 'model' 2: ``PAR.Owned``, the owner
    computes it whole, the other adds x · 0) and the F-split ones (at
    'model' 4) both take the gated unit they are handed, never the
    SwiGLU; on the ranks the FFN's blocks are layer blocks on (2, 2) and
    F blocks on (1, 4), and the train steps above hold."""
    cfg = _config("whisper-small").segments[0].pattern[0].cfg
    g = torch.Generator().manual_seed(0)
    p = {k: torch.randn(*s, generator=g) for k, s in (
        ("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    x = torch.randn(2, 3, 64, generator=g, requires_grad=True)
    ax = PAR.ModelAxis(None, 0, 2)
    want = B._geglu(p, x)
    assert not torch.allclose(want, B._swiglu(p, x))
    own = B._ffn_apply_sharded(PAR.Owned(p, True), x, cfg, ax, B._geglu)
    torch.testing.assert_close(own, want, rtol=0, atol=0)
    other = B._ffn_apply_sharded(PAR.Owned(None, False), x, cfg, ax,
                                 B._geglu)
    assert other.grad_fn is not None and not other.detach().any()
    half = {"w_gate": p["w_gate"][:, :64], "w_up": p["w_up"][:, :64],
            "w_down": p["w_down"][:64]}
    torch.testing.assert_close(
        B._ffn_apply_sharded(half, x, cfg, ax, B._geglu), B._geglu(half, x))
    for shape, lead in (((2, 2), (1, 64, 64)), ((1, 4), (2, 64, 32))):
        mesh = Sizes(data=shape[0], model=shape[1])
        structs = _structs(_config("whisper-small"))
        spec = SH.param_specs(structs, mesh)["segments"][0][0]["ffn"]
        blk = _blocks(structs["segments"][0][0]["ffn"]["w_gate"],
                      spec["w_gate"], mesh)[0]
        assert blk == lead


def test_xlstm_decode_state_is_not_head_blocked(world):
    """``state_specs`` puts the mLSTM's C (L, B, H, dh, dh) on its v rows,
    n on k's index and m on the heads, the sLSTM's (c, n, m, h) on D; a
    decode step gathers m of every head, sums n·q and gathers h
    (``nn/xlstm._mlstm_decode_blocks``), and the Engine's tokens are one
    rank's on both meshes."""
    m = _config("xlstm-1.3b")
    states = MB.init_decode_state(_structs(m), m, 2, 16)
    mesh = Sizes(data=1, model=2)
    specs = SH.state_specs(states, mesh, 2)
    (c, n, mm), (sc, sn, sm, sh) = specs[0]
    assert (c, n, mm) == (SH.P(None, None, None, "model", None),
                          SH.P(None, None, None, "model"),
                          SH.P(None, None, "model"))
    assert sc == sn == sm == sh == SH.P(None, None, "model")
    for shape in MODEL_MESHES:
        for seen in _runs(world, shape, "xlstm-1.3b"):
            assert seen["tokens"] == seen["one_tokens"]


def test_whisper_keeps_its_table_whole():
    """whisper-small's vocab (51865) does not divide over 'model' 2, so
    its embedding table stays whole on every rank: a rank's blocks are
    0.57 of the params, so a gate on the bytes kept reads the spec
    blocks', not a fraction of the whole."""
    m = TC.get_arch("whisper-small")
    structs = _structs(m)
    mesh = Sizes(data=1, model=2)
    specs = SH.param_specs(structs, mesh)
    assert specs["embed"]["table"] == SH.P(None, None)
    full = 4 * sum(t.numel() for t in tree_leaves(structs))
    kept = _nbytes(_blocks(structs, specs, mesh))
    assert 0.56 < kept / full < 0.58


def test_slstm_recurrence_couples_every_head_to_every_channel():
    """The reference's recurrent product ``einsum("bhd,hde->bhe", h,
    rh).reshape(B, 4D)`` sends head j's 4·dh columns to the gate-major
    columns [j·4dh, (j+1)·4dh): at H = 4 head j feeds gate j of every
    channel.  So a rank holding a block of heads (or of channels) cannot
    run a step alone, and the sLSTM runs replicated across 'model'."""
    g = torch.Generator().manual_seed(0)
    b, h, dh = 2, 4, 16
    d = h * dh
    rh = torch.randn(h, dh, 4 * dh, generator=g)
    hh = torch.randn(b, h, dh, generator=g)

    def rec(x):
        return torch.einsum("bhd,hde->bhe", x, rh).reshape(b, 4 * d)

    for head in range(h):
        bumped = hh.clone()
        bumped[:, head] += 1.0
        moved = (rec(bumped) - rec(hh)).abs().reshape(b, 4, d).amax(0) > 0
        # gate `head` of every channel moves, and no other gate
        assert moved[head].all() and not moved[torch.arange(4) != head].any()


def test_the_input_gate_bias_has_no_gradient():
    """The mLSTM's b_i shifts every step's input gate of a head alike, and
    the stabiliser m absorbs the shift (m_new = max(log f + m, i), from m
    = -1e30), so C, n and h do not move: its gradient is 0 up to
    rounding, the leaf the gradient gates floor."""
    m = _config("xlstm-1.3b")
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, m.vocab,
                                                              (2, 24)))
    from repro_torch.train import step as TS

    _, grads = TS.loss_and_grads(m, params, {"tokens": toks,
                                             "labels": toks.roll(-1, 1)})
    total = float(torch.sqrt(sum(torch.sum(g * g)
                                 for g in tree_leaves(grads))))
    for seg in grads["segments"]:
        for g in seg:
            if "b_i" in g:
                assert float(g["b_i"].abs().max()) < 1e-6 * total
                assert float(g["b_f"].abs().max()) > 1e-5 * total


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_a_recurrent_state_split_by_a_batch_axis_decodes(world, arch):
    """At one lane on (2, 2), ``state_spec`` puts 'data' on the SSM
    state's Di (2·512) and the sLSTM state's D (1024), since the batch
    does not divide over it; the decode step gathers that dim before the
    layer's step and keeps this rank's block of the new state after it
    (``models/base._step_layout``): each rank stores its spec blocks, and
    WIDE_STEPS steps' logits and the new states are one rank's."""
    shape = (2, 2)
    mesh = Sizes(data=shape[0], model=shape[1])
    m = wide_config(TB, arch)
    states = MB.init_decode_state(_structs(m), m, 1, REC_CACHE)
    specs = SH.state_specs(states, mesh, 1)
    recurrent = [leaf for seg, seg_ss in zip(m.segments, specs)
                 for sp, ss in zip(seg.pattern, seg_ss)
                 for leaf in (ss if sp.kind in MB.RECURRENT
                              else ss.get("ssm", ()))]
    assert recurrent and any(e == "data" for leaf in recurrent
                             for e in leaf[2:])
    want = _blocks(states, specs, mesh)
    for r in range(WORLD):
        wide = world[0][r][shape]["wide"][arch]
        assert wide["shapes"] == want
        got, one = wide["sharded"], wide["one"]
        assert got["logits"].shape == one["logits"].shape == (
            1, WIDE_STEPS, m.vocab)
        assert np.isfinite(got["logits"]).all()
        assert np.abs(got["logits"] - one["logits"]).max() <= \
            1e-5 * _scale(one["logits"])
        assert len(got["states"]) == len(one["states"])
        for a, b in zip(got["states"], one["states"]):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-5 * _scale(b)
