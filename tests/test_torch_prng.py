"""The port's threefry against ``jax.random``, bit for bit, for exactly the
calls G's noise uses: ``PRNGKey(uint32 seed)`` over the host-int64 masked
seeds of ``task_keys``, ``fold_in(key, s)``, and
``uniform(key, (1, noise_dim), float32, -0.1, 0.1)``.  Tolerance: none —
keys and noise compare as integers / float bit patterns."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import explorer as JE
from repro.core import gan as JG
from repro_torch.core import explorer as E
from repro_torch.core import gan as G
from repro_torch.core import prng

SEEDS = [
    0, 1, 7, 123456,
    2**31 - 1, 2**31, 2**32 - 1,         # around the int32/uint32 edges
    2**40 + 5, 2**62 + 11,              # int64 seeds: low 32 bits
    -1, -2**31, -12345,                 # negatives as task_keys masks them
]


@pytest.mark.parametrize("seed", [0, 2**31 - 3, 2**32 - 2, -5, 2**45])
def test_task_keys_match_jax(seed):
    """Scalar seeds run seed + arange(n): sums that cross 2**31 / 2**32."""
    got = E.task_keys(seed, 6).numpy()
    want = np.asarray(JE.task_keys(seed, 6)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_task_keys_match_jax_per_row_seeds():
    seeds = np.asarray(SEEDS, np.int64)
    got = E.task_keys(seeds, len(seeds)).numpy()
    want = np.asarray(JE.task_keys(seeds, len(seeds))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [0, 1, 3, 255, 2**31 + 3, 2**32 - 1])
def test_fold_in_matches_jax(s):
    keys = JE.task_keys(np.asarray(SEEDS, np.int64), len(SEEDS))
    want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, s))(keys))
    got = prng.fold_in(torch.from_numpy(np.asarray(keys).astype(np.int64)), s)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("noise_dim", [1, 8, 13])
def test_uniform_noise_matches_jax(noise_dim):
    keys = JE.task_keys(np.asarray(SEEDS, np.int64), len(SEEDS))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (1, noise_dim), jnp.float32, -0.1, 0.1))(keys))[:, 0]
    got = prng.uniform(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                       noise_dim, -0.1, 0.1).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_samples", [1, 3])
def test_flattened_draws_match_reference(n_samples):
    """The whole noise path of the explorer: task keys -> fold_in per
    sample -> uniform rows, in the reference's task-major row layout."""
    cfg_j = JG.GANConfig(n_net=6)
    cfg_t = G.GANConfig(n_net=6)
    seeds = np.asarray(SEEDS, np.int64)
    t = len(seeds)
    net = np.arange(t * 6, dtype=np.float32).reshape(t, 6)
    obj = np.arange(t * 2, dtype=np.float32).reshape(t, 2)

    def noise_fn(key, s):
        return JG.sample_noise(jax.random.fold_in(key, s), 1, cfg_j)[0]

    jn, jo, jz = JE.flatten_task_draws(jnp.asarray(net), jnp.asarray(obj),
                                       JE.task_keys(seeds, t), n_samples,
                                       noise_fn)
    tn, to, tz = E.flatten_task_draws(
        torch.from_numpy(net), torch.from_numpy(obj), E.task_keys(seeds, t),
        n_samples, lambda k: G.sample_noise(k, cfg_t))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tz.numpy().view(np.uint32),
                                  np.asarray(jz).view(np.uint32))


def test_random_bits_match_jax_beyond_one_block():
    keys = JE.task_keys(np.asarray(SEEDS[:4], np.int64), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (7, 37)))(keys))
    got = prng.random_bits(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                           7 * 37)
    np.testing.assert_array_equal(got.numpy(),
                                  want.reshape(4, -1).astype(np.int64))


def _fma_exact(a, b, c):
    """float32 a*b+c rounded once, with exact rational arithmetic."""
    ex = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    d = np.float32(float(ex))
    cands = [np.nextafter(d, np.float32(-np.inf)), d,
             np.nextafter(d, np.float32(np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - ex),
                                     int(np.asarray(x).view(np.uint32)) & 1))


def test_fma_f32_rounds_once(rng):
    n = 4000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)) \
        .astype(np.float32)
    got = prng.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)],
                    np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
