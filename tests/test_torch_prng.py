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


#: (a, b, c) whose float64 sum a*b + c lands exactly halfway between two
#: float32 values while the exact sum does not (2^-24 (1 + 2^-15) times
#: 1 - 2^-15 is 2^-24 - 2^-54; 641 * 6700417 is 2^32 + 1, so the last
#: case's exact sum is 2^-127 + 2^-150 + 2^-182, halfway between two
#: subnormals in float64), plus other subnormal results
_P, _Q = np.float32(2.0**-24 * (1 + 2.0**-15)), np.float32(1 - 2.0**-15)
FMA_EDGE_CASES = {
    "halfway, tie to even right": (_P, _Q, np.float32(1.0)),
    "halfway, tie to even wrong": (_P, _Q, np.float32(1 + 2.0**-23)),
    "halfway, negated": (-_P, _Q, np.float32(-1 - 2.0**-23)),
    "halfway, large": (_P * np.float32(2.0**60), _Q,
                       np.float32(2.0**60 * (1 + 2.0**-23))),
    "subnormal product": (np.float32(2.0**-70), np.float32(3 * 2.0**-70),
                          np.float32(0.0)),
    "subnormal sum": (np.float32(2.0**-75), np.float32(3 * 2.0**-75),
                      np.float32(2.0**-149 * (1 - 2.0**-20))),
    "subnormal halfway": (np.float32(641 * 2.0**-91),
                          np.float32(6700417 * 2.0**-91),
                          np.float32(2.0**-127)),
    "zero": (np.float32(0.5), np.float32(-2.0), np.float32(1.0)),
}


@pytest.mark.parametrize("case", list(FMA_EDGE_CASES))
def test_fma_f32_halfway_and_subnormal(case):
    """The elements `fma_f32` redoes exactly: a float64 sum on a float32
    halfway point (both sides of the tie) and subnormal results, with
    tensor or Python-float multiplier and addend."""
    a, b, c = FMA_EDGE_CASES[case]
    want = np.float32(_fma_exact(a, b, c))
    ta = torch.from_numpy(np.asarray([a, a], np.float32))
    for bb, cc in ((torch.tensor([b, b]), torch.tensor([c, c])),
                   (float(b), float(c))):
        got = prng.fma_f32(ta, bb, cc).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.full(2, want).view(np.uint32))


def test_round_sqrt_repairs_one_ulp(rng):
    """`_sqrt_f32` is correctly rounded, and `_round_sqrt` turns a first
    value one ulp off either way (as torch's sqrt on the CPU sometimes
    gives) into the correctly rounded one; 0, inf and NaN pass."""
    a = np.concatenate([10.0 ** rng.uniform(-44, 38, 1 << 14),
                        rng.uniform(0, 30, 1 << 14)]).astype(np.float32)
    a = a[a > 0]
    want = np.sqrt(a.astype(np.float64)).astype(np.float32)
    ta = torch.from_numpy(a)
    np.testing.assert_array_equal(prng._sqrt_f32(ta).numpy(), want)
    for off in (-np.inf, np.inf):
        cand = torch.from_numpy(np.nextafter(want, np.float32(off)))
        np.testing.assert_array_equal(prng._round_sqrt(ta, cand).numpy(),
                                      want)
    ends = torch.tensor([0.0, np.inf, np.nan])
    got = prng._sqrt_f32(ends).numpy()
    assert got[0] == 0 and got[1] == np.inf and np.isnan(got[2])


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


# ---------------------------------------------------------------------------
# normal: G's and D's initial weights
# ---------------------------------------------------------------------------
#: (seed, shape, split index or None): 2^20 draws in the first case
#: alone, then the shapes of G's and D's layers, from split keys
NORMAL_CASES = [(0, (1 << 20,), None), (1, (1024, 1024), 1),
                (7, (81, 2048), 2), (2**31 + 5, (333, 77), None),
                (11, (2048, 73), 1)]


def assert_normal_bits(got, want):
    """got == want, float32 bit for bit."""
    got, want = np.ravel(got), np.ravel(want)
    assert got.dtype == want.dtype == np.float32
    off = np.nonzero(got.view(np.uint32) != want.view(np.uint32))[0]
    assert len(off) == 0, f"{len(off)} elements differ, first at {off[:4]}"


@pytest.mark.parametrize("seed,shape,sub", NORMAL_CASES)
def test_normal_matches_jax(seed, shape, sub):
    """``jax.random.normal(key, shape, float32)`` bit for bit (erf_inv and
    the log1p inside it evaluated as XLA on the CPU evaluates them)."""
    key = jax.random.PRNGKey(seed)
    if sub is not None:
        key = jax.random.split(key, 3)[sub]
    want = np.asarray(jax.random.normal(key, shape, jnp.float32)).ravel()
    got = prng.normal(torch.from_numpy(np.asarray(key).astype(np.int64)),
                      int(np.prod(shape))).numpy()
    assert_normal_bits(got, want)


def _same_bits(got, want):
    """Equal bit patterns, any NaN equal to any NaN."""
    both_nan = np.isnan(got) & np.isnan(want)
    return np.all((got.view(np.uint32) == want.view(np.uint32)) | both_nan)


def test_erf_inv_matches_xla(rng):
    """``lax.erf_inv`` over (-1, 1), both of its branches (w = 5 falls at
    |x| ~ 0.99662), log1p's branch edge (x^2 = sqrt(2) - 1), +-1 -> +-inf,
    and NaN outside [-1, 1]."""
    edge = np.float32(0.41421356) ** np.float32(0.5)
    x = np.concatenate([
        rng.uniform(-1, 1, 1 << 18), rng.uniform(0.99, 1.0, 1 << 14),
        np.linspace(0.9966, 0.99665, 4097),
        [0.0, -0.0, 1.0, -1.0, 1.5, np.nan, edge, -edge,
         np.nextafter(np.float32(1), np.float32(0))]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    assert _same_bits(got, want)


def test_log1p_matches_xla(rng):
    """``jnp.log1p`` in float32 over both branches (|x| < sqrt(2) - 1 and
    beyond), large arguments, subnormals (taken as zeros of their sign),
    -1 -> -inf, < -1 -> NaN, inf -> inf."""
    x = np.concatenate([
        rng.uniform(-1, 1, 1 << 18), 10.0 ** rng.uniform(-30, 30, 1 << 16),
        -(10.0 ** rng.uniform(-30, 0, 1 << 16)),
        [0.0, -0.0, -1.0, -1.5, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
         0.41421354, -0.41421354, 0.41421357, 3.4e38]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = prng.log1p_f32(torch.from_numpy(x)).numpy()
    assert _same_bits(got, want)


#: randint spans: SA's dimension draw and DRL's action draw (4-73), a span
#: of one, empty and inverted ranges (minval comes back), negative bounds,
#: and spans past 2**16, where jax's uint32 multiplier wraps to zero
RANDINT_SPANS = [(0, 4), (0, 7), (0, 73), (0, 1), (3, 3), (5, 2),
                 (-100, 100), (0, 65536), (0, 65537), (0, 10**6),
                 (0, 2**31 - 1), (-2**31, 2**31 - 1)]


@pytest.mark.parametrize("lo,hi", RANDINT_SPANS)
def test_randint_matches_jax(lo, hi):
    keys = JE.task_keys(np.asarray(SEEDS, np.int64), len(SEEDS))
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (37,), lo, hi))(keys))
    got = prng.randint(tkeys, 37, lo, hi)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a scalar draw (shape ()) is the first element of the flat draw
    scalar = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (), lo, hi))(keys))
    np.testing.assert_array_equal(prng.randint(tkeys, 1, lo, hi)[:, 0].numpy(),
                                  scalar.astype(np.int64))


def test_randint_of_split_key_batches_matches_jax():
    """SA's and DRL's draw pattern: split(key, 6) a step, randint and
    scalar uniforms from the subkeys, over a (T, steps) key batch."""
    key = jax.random.PRNGKey(17)
    tkey = prng.prng_key(torch.tensor(17))
    for _ in range(3):
        jk = jax.random.split(key, 6)
        tk = prng.split(tkey, 6)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
        assert int(prng.randint(tk[1], 1, 0, 7)[0]) == \
            int(jax.random.randint(jk[1], (), 0, 7))
        for i in range(2, 6):
            got = prng.uniform(tk[i], 1, 0.0, 1.0)[0]
            want = np.float32(jax.random.uniform(jk[i]))
            assert got.numpy().view(np.uint32) == want.view(np.uint32)
        key, tkey = jk[0], tk[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_scalar_uniform_matches_jax(seed):
    """``uniform(key)`` of shape () has the bits of a one-element draw."""
    keys = JE.task_keys(seed, 64)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k))(keys))
    got = prng.uniform(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                       1, 0.0, 1.0)[:, 0].numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("base", [0.95, 0.9, 0.99, 0.5, 0.8, 1.5])
def test_pow_f32_matches_xla(base):
    """XLA's float32 pow of a float32 base over integer and fractional
    exponents, subnormal and overflowing results included."""
    y = np.concatenate([np.arange(0, 400), np.linspace(-3.0, 40.0, 97)]) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda e: jnp.power(jnp.float32(base), e))(
        jnp.asarray(y)))
    got = prng.pow_f32(float(np.float32(base)), y)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
