"""The LM's initial weights from a seed, against the reference's.

``models/base.init_params(prng_key(seed), m, device)`` draws through the
port's threefry (``core/prng``) with the reference's splits and fold-ins,
so every leaf of every ported arch's reduced config is the reference's
``init_params(PRNGKey(seed), m)`` leaf bit for bit (``np.array_equal``,
no tolerance).  A leaf larger than ``prng.CHUNK`` is drawn in pieces of
counters; the pieces give the one draw's bits.  The training launcher,
started from a seed, takes the reference's first step (its loss within
rtol 1e-5: float32 sums taken in another order).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import train as JLT
from repro.models import base as JMB
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.launch import train as TLT
from repro_torch.models import base as TMB

ARCHS = ["gemma3-1b", "qwen3-14b", "stablelm-1.6b", "deepseek-coder-33b",
         "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "xlstm-1.3b",
         "whisper-small", "qwen2-vl-7b"]


def _key(seed: int) -> torch.Tensor:
    return prng.prng_key(torch.tensor(seed))


def _assert_same_leaves(want, got_params):
    """Every leaf of the reference's params equals the port's, bit for
    bit, at the same path and shape."""
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = jax.tree.leaves(convert.lm_params_to_numpy(got_params))
    assert len(got) == len(want)
    for (path, a), b in zip(want, got):
        a = np.asarray(a)
        assert a.shape == b.shape and b.dtype == np.float32, \
            jax.tree_util.keystr(path)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), \
            jax.tree_util.keystr(path)


def test_every_ported_arch_is_checked():
    assert sorted(TC.canonical(a) for a in ARCHS) == sorted(TC.PORTED)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_equal_the_reference_bit_for_bit(arch, seed):
    want = JMB.init_params(jax.random.PRNGKey(seed), JC.get_reduced(arch))
    got = TMB.init_params(_key(seed), TC.get_reduced(arch), "cpu")
    _assert_same_leaves(want, got)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "hymba-1.5b"])
def test_init_params_in_small_chunks_are_the_same_bits(arch, monkeypatch):
    """With the chunk cut to 1000 counters every leaf above it is drawn
    in pieces (mixtral's stacked experts, hymba's in_proj and the
    embedding) and still equals the reference's."""
    monkeypatch.setattr(prng, "CHUNK", 1000)
    want = JMB.init_params(jax.random.PRNGKey(3), JC.get_reduced(arch))
    _assert_same_leaves(want, TMB.init_params(_key(3), TC.get_reduced(arch),
                                              "cpu"))


@pytest.mark.parametrize("shape,chunk", [((1000,), 64), ((37, 29), 7),
                                         ((3, 5, 11), 165),
                                         ((4096,), 4095)])
def test_chunked_draw_equals_one_draw_and_jax(shape, chunk, monkeypatch):
    key = _key(11)
    scale = (2.0 / 37) ** 0.5
    one = prng.normal_scaled(key, shape, scale, "cpu")
    monkeypatch.setattr(prng, "CHUNK", chunk)
    pieces = prng.normal_scaled(key, shape, scale, "cpu")
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), shape,
                                        jnp.float32) * scale)
    assert one.shape == pieces.shape == shape
    np.testing.assert_array_equal(pieces.numpy(), one.numpy())
    np.testing.assert_array_equal(one.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_normal_at_a_counter_offset_is_that_slice_of_the_draw():
    key = _key(5)
    whole = prng.normal(key, 300)
    np.testing.assert_array_equal(prng.normal(key, 100, 150).numpy(),
                                  whole[150:250].numpy())


@pytest.mark.parametrize("seed", [0, 7])
def test_train_launcher_starts_from_the_reference_first_loss(seed, tmp_path):
    """``launch/train --seed s`` on reduced stablelm on the CPU: the first
    step's loss is the reference launcher's (both packages now start from
    the same weights; no params cross between them)."""
    base = ["--arch", "stablelm-1.6b", "--batch", "4", "--seq", "32",
            "--steps", "2", "--log-every", "1", "--seed", str(seed)]
    h_ref, h_port = str(tmp_path / "r.json"), str(tmp_path / "p.json")
    JLT.main(base + ["--ckpt-dir", str(tmp_path / "r"),
                     "--history-out", h_ref])
    TLT.main(base + ["--ckpt-dir", str(tmp_path / "p"), "--history-out",
                     h_port, "--device", "cpu"])
    with open(h_ref) as f:
        want = [r["loss"] for r in json.load(f)]
    with open(h_port) as f:
        got = [r["loss"] for r in json.load(f)]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
