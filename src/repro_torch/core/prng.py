"""Threefry-2x32 counter-based PRNG: the bits of exactly the reference's
noise calls, so seed s draws the same G noise in both packages.

G's noise for task key k and sample s is
``uniform(fold_in(k, s), (1, noise_dim), float32, -0.1, 0.1)`` with
``k = PRNGKey(uint32(seed))`` (the reference's ``task_keys``).  This
module reproduces those three calls bit for bit:

- ``prng_key(seed)``: a uint32 seed becomes the key ``(0, seed)``;
- ``fold_in(key, s)``: ``threefry2x32(key, (0, s))``;
- ``split(key, n)``: in partitionable mode key i of the split is
  ``fold_in(key, i)`` (Algorithm 1's ``rng, nrng = split(rng)``);
- ``randint(key, n, lo, hi)``: two such draws reduced into the span
  by jax's multiplier rule (SA's and DRL's integer draws);
- ``uniform(key, n, lo, hi)``: the *partitionable* bit recipe — element
  i of the flattened shape hashes the 64-bit counter ``(hi=0, lo=i)`` and
  takes ``bits1 ^ bits2`` — then the float recipe: the top 23 bits become
  the mantissa of a float in [1, 2), minus 1, scaled into [lo, hi).
  XLA on the CPU contracts that scale, ``f * (hi - lo) + lo``, into one
  fused multiply-add, so `fma_f32` rounds it once, as an FMA does;
- ``normal(key, n)``: ``sqrt(2) * erf_inv(uniform(key, n, nextafter(-1,
  0), 1))``, the initial weights of G and D, with ``erf_inv`` and the
  ``log1p`` inside it evaluated step for step as XLA on the CPU emits them
  (see `erf_inv`);
- ``normal_scaled(key, shape, scale)``: ``normal(key, shape) * scale``,
  how the reference draws each LM weight (``models/base.init_params``);
  a large leaf is drawn in pieces of counters (``start``), the same bits.

Partitionable mode (``jax_threefry_partitionable``) is on by default in
current JAX and is what this module follows; the legacy mode drew the
same threefry hash over a different counter layout and gives other bits.

Keys are int64 tensors of shape (..., 2) holding uint32 values; all
arithmetic is integer torch ops on int64 masked to 32 bits (torch's
uint32 supports few operations).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2); all int64 tensors holding uint32 values, broadcast.
    Returns the two output words.

    x1 is only ever added to, and reaches x2 through an xor that is masked,
    so it is reduced mod 2^32 once, at the end (it stays below 2^37).
    On the ``meta`` device the words' shapes alone (a key is hashed only
    to shape the draws ``normal_scaled`` then skips)."""
    if k1.is_meta:
        shape = torch.broadcast_shapes(*(torch.as_tensor(t).shape
                                         for t in (k1, k2, x1, x2)))
        return (torch.empty(shape, dtype=torch.int64, device="meta"),) * 2
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = x1 + ks[0]
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & MASK32
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + (ks[(i + 2) % 3] + (i + 1))) & MASK32
    return x1 & MASK32, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``PRNGKey`` of uint32 seeds: (...,) int64 in [0, 2**32) -> (..., 2)."""
    seed = seed.to(torch.int64) & MASK32
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in(key, data)``: (..., 2) keys, integer data broadcast
    against the key batch -> (..., 2) keys."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (..., 2) keys -> (..., n, 2)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], i)


def random_bits(key: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """32-bit random words of the flattened elements ``start .. start + n``
    of a shape under 2**32 elements: (..., 2) keys -> (..., n) int64 in
    [0, 2**32).  Element i hashes the counter (0, i), so a draw made in
    pieces of counters is the one draw."""
    lo = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float, maxval: float,
            start: int = 0) -> torch.Tensor:
    """``uniform(key, shape, float32, minval, maxval)`` for a shape of n
    elements (row-major flat), or its elements ``start .. start + n``:
    (..., 2) keys -> (..., n) float32."""
    bits = random_bits(key, n, start)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo, hi = _f32(minval, maxval)
    # float32's hi - lo: rounding the float64 difference of two float32
    # values to float32 is the float32 difference (53 >= 2 * 24 + 2)
    return torch.clamp(fma_f32(floats, _f32(hi - lo)[0], lo), min=lo)


def randint(key: torch.Tensor, n: int, minval, maxval) -> torch.Tensor:
    """``randint(key, shape, minval, maxval)`` (int32) for a shape of n
    elements: jax 0.9's ``_randint``.  Two 32-bit draws from ``k1, k2 =
    split(key)`` are reduced into the span by jax's multiplier rule —
    ``((hi % span) * (2^32 % span) + lo % span) % span`` with uint32
    wrap-around, not a plain modulo — and a span <= 0 gives minval.
    Bounds are ints within int32, or int64 tensors broadcast against the
    draws.  (..., 2) keys -> (..., n) int64."""
    k = split(key)
    hi = random_bits(k[..., 0, :], n)
    lo = random_bits(k[..., 1, :], n)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = torch.where(maxval <= minval, 1, (maxval - minval) & MASK32)
    # 2^32 % span as jax takes it: (2^16 % span)^2 wraps in uint32, so a
    # span above 2^16 gets the multiplier 0
    mult = ((((1 << 16) % span) ** 2) & MASK32) % span
    a = hi % span
    # (a * mult) mod 2^32 in int64: mult split into 16-bit halves
    prod = (a * (mult & 0xFFFF) + (((a * (mult >> 16)) & 0xFFFF) << 16))
    offset = ((prod + lo % span) & MASK32) % span
    return minval + offset


#: float32's smallest normal
_TINY = 2.0 ** -126


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add): `a` a
    float32 tensor, `b` and `c` float32 tensors or Python floats that
    float32 holds exactly.

    The float64 product of two float32 values is exact and the float64
    sum rounds once; rounding that sum to float32 gives the fused result
    unless the sum lies exactly halfway between two float32 values (its
    low 29 bits a one and 28 zeros) or below float32's smallest normal.
    Only those few elements are redone, by `_fma_exact`; on the ``meta``
    device there are none to find."""
    s = a.double() * b + c
    if s.is_meta:
        return s.float()
    shape = s.shape
    s = torch.atleast_1d(s)
    r = s.float()
    suspect = (((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000)
               | (s.abs() < _TINY))
    idx = suspect.nonzero(as_tuple=True)
    if idx[0].numel():
        pick = lambda v: torch.broadcast_to(
            torch.as_tensor(v, device=s.device), s.shape)[idx]
        r[idx] = _fma_exact(pick(a), pick(b), pick(c))
    return r.reshape(shape)


def _fma_exact(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
               ) -> torch.Tensor:
    """`fma_f32` on float32 tensors of one shape, every case: the float64
    sum's exact error ``e`` comes from TwoSum, and where the sum lies
    exactly halfway between two float32 values, ``e`` decides the side."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    r = s.float()
    rd = r.double()
    diff = s - rd
    toward = torch.where(diff > 0, float("inf"), float("-inf")).float()
    n = torch.nextafter(r, toward)
    mid = (diff != 0) & (s == (rd + n.double()) * 0.5)
    past = mid & (e != 0) & ((e > 0) == (diff > 0))
    return torch.where(past, n, r)


def _f32(*values: float) -> tuple:
    return tuple(torch.tensor(v, dtype=torch.float32).item() for v in values)


@functools.lru_cache(maxsize=None)
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    lib.powf.restype = ctypes.c_float
    return lib


def pow_f32(base: float, exponents) -> np.ndarray:
    """XLA-on-CPU's float32 ``pow(base, y)`` for each y (host numpy, the
    temperature schedule of simulated annealing): C's ``powf``, which
    XLA's float32 pow on the CPU matches bit for bit wherever the result
    is a normal number (tests/test_torch_prng.py), with subnormal results
    flushed to zero as XLA's CPU code flushes them.  The float64 power
    rounded once is an ulp away at some exponents."""
    powf = _libm().powf
    out = np.array([powf(base, float(y)) for y in np.asarray(exponents)],
                   np.float32)
    return np.where(np.abs(out) < _TINY, np.float32(0.0), out)


#: XLA's float32 ErfInv (Giles' polynomial in w = -log1p(-x*x)): the
#: coefficients for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = _f32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = _f32(-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)
#: XLA's log1p for |x| < sqrt(2) - 1: x - x^2/2 + x^3 * num(x) / den(x)
#: (Cephes), the coefficients lowest degree first, leading 1 dropped
_LOG1P_NUM = _f32(4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                  6.5787325942061044846969e0, 2.9911919328553073277375e1,
                  6.0949667980987787057556e1, 5.7112963590585538103336e1,
                  2.0039553499201281259648e1)
_LOG1P_DEN = _f32(1.5062909083469192043167e1, 8.3047565967967209469434e1,
                  2.2176239823732856465394e2, 3.0909872225312059774938e2,
                  2.1642788614495947685003e2, 6.0118660497603843919306e1)
#: XLA-on-CPU's float32 log (Cephes logf): the polynomial in m - 1, and
#: ln 2 split as 0.693359375 - 2.12194440e-4
_LOG_P = _f32(7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
              -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
              2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LN2_HI, _LN2_LO, _SQRT_HALF, _SQRT2_M1 = _f32(
    0.693359375, -2.12194440e-4, 0.707106781186547524, 0.41421356237309504880)


def _div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a / b`` correctly rounded: the float64 quotient rounded
    to float32 (double rounding is harmless for / and sqrt, 53 >= 2*24+2)."""
    return (a.double() / b.double()).float()


def _sqrt_f32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt`` correctly rounded: float64's sqrt rounded to
    float32, then checked exactly.  torch's sqrt on the CPU is not always
    correctly rounded: in float32, and in float64 under intra-op threads
    (a few elements of 2^20 come out ~1e-11 off, in some calls only).
    The midpoints between a float32 value and its neighbours have 25
    significant bits, so their squares are exact in float64: a value
    whose midpoints' squares do not bracket `a` moves one ulp, which
    repairs any first value within an ulp (`_round_sqrt`)."""
    return _round_sqrt(a, torch.sqrt(a.double()).float())


def _round_sqrt(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 sqrt of `a` from `r`, within one ulp
    of it (see `_sqrt_f32`); zeros, infinities and NaNs pass through."""
    ad = a.double()
    down = torch.nextafter(r, torch.zeros_like(r))
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    lo = (r.double() + down.double()) * 0.5
    hi = (r.double() + up.double()) * 0.5
    fixed = torch.where(ad < lo * lo, down, torch.where(ad > hi * hi, up, r))
    return torch.where((a > 0) & (a < float("inf")), fixed, r)


def _log_f32(a: torch.Tensor) -> torch.Tensor:
    """XLA-on-CPU's float32 ``log`` (its inlined Cephes ``logf``), with the
    fused multiply-adds its machine code has: ``a = m * 2^e`` with m in
    [sqrt(1/2), sqrt(2)), then a degree-9 polynomial in m - 1 split into
    three interleaved Horner chains in (m - 1)^3."""
    bits = torch.clamp(a, min=_TINY).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = m < _SQRT_HALF
    e = torch.where(low, e - 1.0, e)
    x = (m - 1.0) + torch.where(low, m, 0.0)
    z = x * x
    x3 = z * x
    p = _LOG_P
    a_ = fma_f32(fma_f32(x, p[0], p[1]), x, p[2])
    b_ = fma_f32(fma_f32(x, p[3], p[4]), x, p[5])
    d_ = fma_f32(fma_f32(x, p[6], p[7]), x, p[8])
    y = fma_f32(fma_f32(fma_f32(a_, x3, b_), x3, d_), x3, e * _LN2_LO)
    y = fma_f32(e, _LN2_HI, fma_f32(z, -0.5, x) + y)
    y = torch.where(a == 0, float("-inf"), y)
    y = torch.where(a == float("inf"), float("inf"), y)
    return torch.where((a < 0) | torch.isnan(a), float("nan"), y)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA-on-CPU's float32 ``log1p``: for |x| < sqrt(2) - 1 the rational
    Cephes form, else ``log(1 + x)`` by `_log_f32`; fused where its
    machine code fuses.  XLA on the CPU treats a subnormal input as a
    zero of its sign, and so does this."""
    x = torch.where(x.abs() < _TINY, x * 0.0, x)
    x2 = x * x
    num = fma_f32(x, _LOG1P_NUM[0], _LOG1P_NUM[1])
    for k in _LOG1P_NUM[2:]:
        num = fma_f32(num, x, k)
    den = x + _LOG1P_DEN[0]                   # the leading 1: one rounding
    for k in _LOG1P_DEN[1:]:
        den = fma_f32(den, x, k)
    small = x + fma_f32(x2, -0.5, (x * x2) * _div_f32(num, den))
    return torch.where(x.abs() < _SQRT2_M1, small, _log_f32(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` as XLA on the CPU runs it: w = -log1p(-x^2)
    (`log1p_f32`), Giles' polynomial in w - 2.5 (w < 5) or sqrt(w) - 3,
    each Horner step one fused multiply-add, times x; +-inf at |x| == 1."""
    l = log1p_f32(x * -x)
    lt = l > -5.0                                   # w < 5
    w = torch.where(lt, -2.5 - l, _sqrt_f32(-l) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for k_lt, k_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma_f32(p, w, torch.where(lt, k_lt, k_ge))
    return x * torch.where(x.abs() == 1.0, float("inf"), p)


#: the lower bound of `normal`'s uniform draw, and sqrt(2), in float32
_NORMAL_LO = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
_SQRT2 = _f32(2.0 ** 0.5)[0]


def normal(key: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """``normal(key, shape, float32)`` for a shape of n elements
    (row-major flat), or its elements ``start .. start + n``: ``sqrt(2) *
    erf_inv(u)`` with ``u = uniform(key, n, nextafter(-1, 0), 1)``.
    (..., 2) keys -> (..., n) float32.

    Bit for bit jax's on the CPU over 2^20 draws and more
    (tests/test_torch_prng.py)."""
    return _SQRT2 * erf_inv(uniform(key, n, _NORMAL_LO, 1.0, start))


#: counters `normal_scaled` draws at once: a draw's int64 and float64
#: temporaries are many times its length, so a leaf of hundreds of
#: millions of elements is drawn in pieces
CHUNK = 1 << 24


def normal_scaled(key: torch.Tensor, shape, scale: float, device
                  ) -> torch.Tensor:
    """``normal(key, shape, float32) * scale`` as the reference draws a
    weight (the scale a Python float, so one float32 product): a (2,) key
    -> a float32 tensor of `shape` on `device`.  A leaf of more than
    `CHUNK` elements is drawn `CHUNK` counters at a time into the
    preallocated leaf, which gives the same bits as one draw and bounds
    the temporaries.  On the ``meta`` device nothing is drawn: the leaf's
    shape and dtype alone."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    n = int(np.prod(shape, dtype=np.int64))
    key = key.to(device)
    if n <= CHUNK:
        return (normal(key, n) * scale).reshape(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        out[s:s + m] = normal(key, m, s) * scale
    return out.reshape(shape)


def normals(keys, sizes) -> list:
    """``normal(keys[i], sizes[i])`` for every i, in one pass: the uniform
    draws are concatenated and go through one `erf_inv` (elementwise, so
    the bits are those of separate calls).  A network's layers are drawn
    so, in one call rather than one a layer."""
    u = torch.cat([uniform(k, n, _NORMAL_LO, 1.0)
                   for k, n in zip(keys, sizes)])
    return list((_SQRT2 * erf_inv(u)).split(list(sizes)))
