"""The port's dry-run structs and model flops against the reference's.

For all ten archs at full width and all four ``SHAPES``: the port's
``active_param_fraction_flops`` and ``model_flops_for`` equal the
reference's exactly, the reference fed its own ``param_structs(m,
jnp.float32)`` (``jax.eval_shape``); ``batch_structs``, ``param_structs``
and ``state_structs`` have the reference's shapes and dtypes, leaf for
leaf, at the same paths and so its bytes, at bf16 (both packages'
default) and float32.  The decode states' ``len`` is a Python int in the
port (the reference's is a (repeats,) int32 array).  Then ``build_case``
of every kind runs on meta, and the dry-run's and the perf sweep's CLIs
write their records, in bf16 unless ``--dtype float32``.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro import configs as JC  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import dryrun as JDR  # noqa: E402
from repro.train import step as JTS  # noqa: E402

# the reference's dry-run sets 512 host devices for its own CLI at import;
# the tests here keep the host's
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.shapes import SHAPES, Shape  # noqa: E402
from repro_torch.launch import dryrun as TDR  # noqa: E402
from repro_torch.train import step as TTS  # noqa: E402
from repro_torch.utils import op_cost  # noqa: E402

ARCHS = TC.list_archs()


def _ref_paths(tree) -> dict:
    """{path: shape} of a reference struct tree (dict keys, list and
    tuple indices)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = tuple(leaf.shape)
    return out


def _port_paths(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _port_paths(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _port_paths(t, path + (i,)).items()}
    return {path: tree.shape if torch.is_tensor(tree) else tree}


#: the structs' dtypes held to the reference's: bf16, both packages'
#: default (the reference's dry-run's), and float32
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, dtype: str = "float32"):
    return JTS.param_structs(JC.get_arch(arch), DTYPES[dtype][0])


@functools.lru_cache(maxsize=None)
def _port_params(arch: str, dtype: str = "float32"):
    return TTS.param_structs(TC.get_arch(arch), DTYPES[dtype][1])


def _ref_dtypes(tree) -> dict:
    """{path: the leaf's dtype as a torch dtype's name} of a reference
    struct tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = str(leaf.dtype)
    return out


def _port_dtypes(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _port_dtypes(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _port_dtypes(t, path + (i,)).items()}
    return {path: str(tree.dtype).replace("torch.", "")
            if torch.is_tensor(tree) else "int32"}


def _ref_bytes(tree) -> int:
    return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for leaf in jax.tree.leaves(tree))


def _port_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in jax.tree.leaves(tree, is_leaf=torch.is_tensor)
               if torch.is_tensor(t))


def test_the_shapes_are_the_references():
    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in SHAPES.items()} \
        == {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in JSHAPES.items()}
    assert TDR.TRAIN_MICROBATCHES == JDR.TRAIN_MICROBATCHES
    assert TTS.DECODER_TRAIN_LEN == JTS.WHISPER_DEC_LEN


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_structs_have_the_references_shapes(arch, dtype):
    """At bf16 (the default of both packages) and float32: the
    reference's paths, shapes and dtypes, leaf for leaf, so its bytes."""
    want = _ref_paths(_ref_params(arch, dtype))
    got = _port_paths(_port_params(arch, dtype))
    assert got == want
    assert _port_dtypes(_port_params(arch, dtype)) == _ref_dtypes(
        _ref_params(arch, dtype))
    assert _port_bytes(_port_params(arch, dtype)) == _ref_bytes(
        _ref_params(arch, dtype))
    leaves = jax.tree.leaves(_port_params(arch, dtype),
                             is_leaf=torch.is_tensor)
    assert all(t.is_meta and t.dtype == DTYPES[dtype][1] for t in leaves)
    if dtype == "bf16":
        assert _port_paths(TTS.param_structs(TC.get_arch(arch))) == got
        assert {t.dtype for t in jax.tree.leaves(TTS.param_structs(
            TC.get_arch(arch)), is_leaf=torch.is_tensor)} == {torch.bfloat16}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_references(arch, shape):
    jm, tm = JC.get_arch(arch), TC.get_arch(arch)
    assert TDR.active_param_fraction_flops(tm, _port_params(arch)) == \
        JDR.active_param_fraction_flops(jm, _ref_params(arch))
    assert TDR.model_flops_for(tm, SHAPES[shape], _port_params(arch)) == \
        JDR.model_flops_for(jm, JSHAPES[shape], _ref_params(arch))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_structs_have_the_references_shapes(arch, shape, dtype):
    jdt, tdt = DTYPES[dtype]
    want = JTS.batch_structs(JC.get_arch(arch), JSHAPES[shape], jdt)
    got = TTS.batch_structs(TC.get_arch(arch), SHAPES[shape], tdt)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.is_meta for v in got.values())
    assert {k: v.dtype for k, v in got.items() if k != "frames"} == \
        {k: torch.int32 for k in got if k != "frames"}
    assert _port_bytes(got) == _ref_bytes(want)
    if "frames" in got:
        assert got["frames"].dtype == tdt
        assert TTS.batch_structs(TC.get_arch(arch), SHAPES[shape])[
            "frames"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_structs_have_the_references_shapes(arch, dtype):
    """The KV caches in the dtype, the recurrent states (hymba's SSM
    state, the mLSTM's and sLSTM's) in float32, as the reference's; the
    same bytes but for the reference's (repeats,) int32 ``len``."""
    shape = SHAPES["decode_32k"]
    jm = JC.get_arch(arch)
    jdt, tdt = DTYPES[dtype]
    ref = JTS.state_structs(_ref_params(arch, dtype), jm, shape.global_batch,
                            shape.seq_len, jdt)
    port = TTS.state_structs(_port_params(arch, dtype), TC.get_arch(arch),
                             shape.global_batch, shape.seq_len, tdt)
    want = _ref_paths(ref)
    got = _port_paths(port)
    lens = {k for k in want if k[-1] == "len"}
    want_dt, got_dt = _ref_dtypes(ref), _port_dtypes(port)
    assert {k: v for k, v in got_dt.items() if k not in lens} == \
        {k: v for k, v in want_dt.items() if k not in lens}
    n_len = sum(int(np.prod(want[k])) * 4 for k in lens)
    assert _port_bytes(port) == _ref_bytes(ref) - n_len
    if dtype == "bf16":
        default = TTS.state_structs(_port_params(arch, dtype),
                                    TC.get_arch(arch), shape.global_batch,
                                    shape.seq_len)
        assert _port_dtypes(default) == got_dt
    assert {k for k in got if k[-1] == "len"} == lens
    assert all(got[k] == 0 for k in lens)
    assert {k: v for k, v in got.items() if k not in lens} == \
        {k: v for k, v in want.items() if k not in lens}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_case_runs_every_kind_on_meta(kind):
    """A reduced whisper (frames, enc_out) and qwen2-vl (positions) case
    of each kind runs on meta; its outputs are meta tensors."""
    for arch in ("whisper-small", "qwen2-vl-7b"):
        case = TTS.build_case(TC.get_reduced(arch),
                              Shape(f"{kind}_2x64", 64, 2, kind),
                              microbatches=2 if kind == "train" else 1)
        out, c = op_cost.count(case.fn, *case.args)
        leaves = [t for t in jax.tree.leaves(out, is_leaf=torch.is_tensor)
                  if torch.is_tensor(t)]
        assert leaves and all(t.is_meta for t in leaves)
        assert c.totals()["flops"] > 0


def test_dryrun_cli_writes_its_records(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    assert TDR.main(["--arch", "gemma3-1b", "stablelm-1.6b", "--shape",
                     "long_500k", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"], r["status"], r["dtype"])
            for r in recs] == [("gemma3-1b", "long_500k", "ok", "bf16"),
                               ("stablelm-1.6b", "long_500k", "skipped",
                                "bf16")]
    ok = recs[0]
    assert ok["chips"] == 1 and ok["bottleneck"] == "memory"
    assert ok["fits"] == (ok["bytes_per_device"] <= TDR.CARD_BYTES)
    assert ok["collectives"]["coll_bytes"] == 0
    assert "[dryrun] gemma3-1b" in capsys.readouterr().out


@pytest.mark.parametrize("cli", ["dryrun", "perf"])
def test_the_cost_clis_count_bf16_by_default(cli, tmp_path):
    """Both CLIs take ``--dtype bf16|float32`` and default to bf16, as the
    reference's dry-run and perf sweep count; float32 counts the same
    cell's params and batch at twice the bytes."""
    from repro_torch.launch import perf as TPF

    shape = Shape("train_2x64", 64, 2, "train")
    m = TC.get_reduced("hymba-1.5b")
    recs = {}
    for dtype in (None, "bf16", "float32"):
        out = tmp_path / f"{cli}-{dtype}.jsonl"
        args = ["--out", str(out)] + (["--dtype", dtype] if dtype else [])
        if cli == "dryrun":
            rec = TDR.run_cell(m, shape, dtype=dtype or "bf16")
            assert TDR.main(["--arch", "stablelm-1.6b", "--shape",
                             "long_500k"] + args) == 0
            assert json.loads(out.read_text())["dtype"] == (dtype or "bf16")
        else:
            assert TPF.main(["--arch", "hymba-1.5b", "--reduced", "--batch",
                             "2", "--seq", "64", "--shape", "train_4k"]
                            + args) == 0
            rec = json.loads(out.read_text())
        assert rec["status"] == "ok" and rec["dtype"] == (dtype or "bf16")
        recs[dtype] = rec
    assert recs[None]["bytes_per_device"] == recs["bf16"]["bytes_per_device"]
    assert recs["float32"]["bytes_per_device"] > 1.5 * recs["bf16"][
        "bytes_per_device"]
    if cli == "dryrun":
        assert recs["float32"]["arg_bytes"] > 1.9 * recs["bf16"]["arg_bytes"]
