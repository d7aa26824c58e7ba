"""The port's kernels against the reference package: the whole-MLP
forward, the dense layer of training with its two backward kernels, and
the flash-attention forward; on the card also the selective scan of
hymba's SSM branch and xLSTM's sLSTM recurrence (whose CPU routes, the
plain loops, are held to the reference in ``tests/test_torch_ssm.py``
and ``tests/test_torch_xlstm.py``).

On the CPU each wrapper takes its plain version; these tests hold that
plain version (and the dispatch and autograd around it) to the
reference's Pallas kernels in interpret mode (under ``jax.vjp`` for the
backward) and to its jnp oracle, on the same numpy inputs.  Tolerance:
atol = rtol = 1e-5, float32 sums taken in another order.

The ``cuda`` tests hold each CUDA kernel to its plain version on an H100
and skip elsewhere; they import nothing of the reference package, so they
run on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels import dispatch as D
from repro_torch.kernels import fused_dense as FD
from repro_torch.kernels import fused_mlp as FM
from repro_torch.kernels import ref
from repro_torch.nn import layers as L

TOL = 1e-5

#: (rows, layer widths): ragged hidden widths and heads as the explorer
#: sees them (input 16, heads 29/73)
SHAPES = [
    (8, [16, 32, 32, 29]),
    (13, [16, 7, 33, 73]),
    (1, [16, 64, 29]),
    (64, [16, 33, 33, 33, 7]),
    (5, [3, 1]),
]


def _mlp(rng, widths, bias_scale=0.1):
    ws = [(rng.normal(size=(a, b)) * (2.0 / a) ** 0.5).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [(rng.normal(size=(b,)) * bias_scale).astype(np.float32)
          for b in widths[1:]]
    return ws, bs


def _reference():
    """The reference package's kernel modules (imported here, not at the
    top: the ``cuda`` tests run where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import fused_mlp as JFM
    from repro.kernels import ref as JREF
    return jax, JFM, JREF


@pytest.mark.parametrize("m,widths", SHAPES)
def test_plain_fused_mlp_matches_pallas_interpret(m, widths, rng):
    jax, JFM, JREF = _reference()
    import jax.numpy as jnp
    ws, bs = _mlp(rng, widths)
    x = rng.normal(size=(m, widths[0])).astype(np.float32)
    got = ref.fused_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                        [torch.from_numpy(b) for b in bs]).numpy()
    jw, jb = [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs]
    pallas = np.asarray(JFM.fused_mlp(jnp.asarray(x), jw, jb, interpret=True))
    oracle = np.asarray(JREF.fused_mlp(jnp.asarray(x), jw, jb))
    assert got.shape == pallas.shape == (m, widths[-1])
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_fused", [None, True, False])
def test_mlp_chain_on_cpu_takes_plain_version(use_fused, rng):
    """A CPU tensor gets the plain version whatever `use_fused` says, and
    the kernel's launch count does not move."""
    jax, _, _ = _reference()
    from repro.kernels import dispatch as JD
    ws, bs = _mlp(rng, [16, 33, 7, 29])
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)    # leading dims
    layers = [{"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
              for w, b in zip(ws, bs)]
    before = FM.fused_mlp.launches
    got = D.mlp_chain(layers, torch.from_numpy(x), use_fused=use_fused)
    assert FM.fused_mlp.launches == before
    want = JD.mlp_chain([{"w": w, "b": b} for w, b in zip(ws, bs)],
                        jax.numpy.asarray(x), use_fused=False)
    assert got.shape == (2, 3, 29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_mlp_apply_matches_reference(rng):
    jax, _, _ = _reference()
    from repro.nn import layers as JL
    ws, bs = _mlp(rng, [16, 32, 32, 29])
    x = rng.normal(size=(9, 16)).astype(np.float32)
    params = {"layers": [{"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
                         for w, b in zip(ws, bs)]}
    got = L.mlp_apply(params, torch.from_numpy(x)).numpy()
    chained = L.mlp_apply_chained(params, torch.from_numpy(x)).numpy()
    want = np.asarray(JL.mlp_apply(
        {"layers": [{"w": w, "b": b} for w, b in zip(ws, bs)]},
        jax.numpy.asarray(x), use_fused=False))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(chained, want, rtol=TOL, atol=TOL)


def test_mlp_init_shapes_and_scales():
    key = prng.prng_key(torch.tensor(0))
    p = L.mlp_init(key, 16, [256, 256], 29, "cpu")
    assert [tuple(q["w"].shape) for q in p["layers"]] == \
        [(16, 256), (256, 256), (256, 29)]
    assert all(float(q["b"].abs().max()) == 0.0 for q in p["layers"])
    # He init on hidden layers, 1/sqrt(fan_in) on the head
    assert abs(float(p["layers"][1]["w"].std()) - (2 / 256) ** 0.5) < 0.01
    assert abs(float(p["layers"][2]["w"].std()) - (1 / 256) ** 0.5) < 0.01
    again = L.mlp_init(prng.prng_key(torch.tensor(0)), 16, [256, 256], 29,
                       "cpu")
    assert torch.equal(again["layers"][0]["w"], p["layers"][0]["w"])


@pytest.mark.parametrize("m,widths", SHAPES[:4])
def test_whole_mlp_gradient_matches_pallas_vjp(m, widths, rng):
    """The whole MLP's backward (``fused_mlp.chain_vjp``: the layer chain
    re-run through ``fused_dense``, the plain versions on CPU tensors)
    against the reference's ``_fused_mlp_vjp`` in interpret mode, for x,
    every w and every b; and the CPU route's autograd agrees."""
    jax, JFM, _ = _reference()
    import jax.numpy as jnp
    ws, bs = _mlp(rng, widths)
    x = rng.normal(size=(m, widths[0])).astype(np.float32)
    dy = rng.normal(size=(m, widths[-1])).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, ws_, bs_: JFM.fused_mlp(
        x_, ws_, bs_, interpret=True), jnp.asarray(x),
        [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    jx, jws, jbs = vjp(jnp.asarray(dy))
    want = [np.asarray(a) for a in (jx, *jws, *jbs)]
    t = [torch.from_numpy(a) for a in (x, *ws, *bs)]
    n = len(ws)
    got = FM.chain_vjp(t[0], t[1:1 + n], t[1 + n:], torch.from_numpy(dy),
                       [True] * (2 * n + 1))
    leaves = [a.clone().requires_grad_() for a in t]
    y = FM.fused_mlp(leaves[0], leaves[1:1 + n], leaves[1 + n:])
    auto = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for i, (g, a, w_) in enumerate(zip(got, auto, want)):
        np.testing.assert_allclose(g.numpy(), w_, rtol=TOL, atol=TOL,
                                   err_msg=f"input {i}")
        np.testing.assert_allclose(a.numpy(), w_, rtol=TOL, atol=TOL,
                                   err_msg=f"autograd input {i}")
    # a gradient not asked for is neither computed nor launched
    part = FM.chain_vjp(t[0], t[1:1 + n], t[1 + n:], torch.from_numpy(dy),
                        [False] + [True] * n + [False] * n)
    assert part[0] is None and all(p is None for p in part[1 + n:])
    for g, w_ in zip(part[1:1 + n], want[1:1 + n]):
        np.testing.assert_allclose(g.numpy(), w_, rtol=TOL, atol=TOL)


#: (M, K, N) of the dense layer: ragged, as Algorithm 1 sees them (inputs
#: 16/37/81 wide, heads 2/29/73 wide)
DENSE_SHAPES = [(37, 29, 73), (8, 16, 29), (5, 81, 2), (33, 64, 32), (1, 3, 1)]


def _dense_inputs(rng, m, k, n):
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * (2.0 / k) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, b, dy


def _pallas_dense_vjp(x, w, b, dy, relu):
    """The reference's fused_dense in interpret mode: y and (dx, dW, db)
    from its custom_vjp at cotangent dy, as numpy."""
    jax, JFM, _ = _reference()
    y, vjp = jax.vjp(lambda x, w, b: JFM.fused_dense(
        x, w, b, relu=relu, interpret=True), x, w, b)
    return [np.array(a) for a in (y, *vjp(jax.numpy.asarray(dy)))]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,k,n", DENSE_SHAPES)
def test_plain_dense_kernels_match_pallas_vjp(m, k, n, relu, rng):
    """The plain forward, dx and dW/db against the Pallas forward and its
    backward kernels; the backward gets the reference's own y, so both
    apply the same mask."""
    x, w, b, dy = _dense_inputs(rng, m, k, n)
    y, dx, dw, db = _pallas_dense_vjp(x, w, b, dy, relu)
    t = torch.from_numpy
    got_y = ref.fused_dense(t(x), t(w), t(b), relu)
    got_dx = ref.dense_dx(t(dy), t(y), t(w), relu)
    got_dw, got_db = ref.dense_dw_db(t(x), t(dy), t(y), relu)
    for got, want, name in ((got_y, y, "y"), (got_dx, dx, "dx"),
                            (got_dw, dw, "dw"), (got_db, db, "db")):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,k,n", DENSE_SHAPES[:3])
def test_fused_dense_autograd_on_cpu_matches_pallas_vjp(m, k, n, relu, rng):
    """``FusedDense`` on CPU tensors (its three wrappers take their plain
    versions; no launch is counted) against the reference's custom_vjp."""
    x, w, b, dy = _dense_inputs(rng, m, k, n)
    y, dx, dw, db = _pallas_dense_vjp(x, w, b, dy, relu)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    counts = (FD.dense_forward.launches, FD.dense_dx.launches,
              FD.dense_dw_db.launches)
    got = FD.fused_dense(tx, tw, tb, relu)
    got.backward(torch.from_numpy(dy))
    assert counts == (FD.dense_forward.launches, FD.dense_dx.launches,
                      FD.dense_dw_db.launches)
    for g, want, name in ((got.detach(), y, "y"), (tx.grad, dx, "dx"),
                          (tw.grad, dw, "dw"), (tb.grad, db, "db")):
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("needs", ["x", "wb", "w", "b", "xwb"])
def test_fused_dense_runs_only_the_backward_kernels_it_needs(needs, rng,
                                                             monkeypatch):
    """dx runs only when x needs a gradient, dW/db only when w or b does —
    the frozen D in G's loss launches dx alone."""
    calls = []
    for name in ("dense_dx", "dense_dw_db"):
        orig = getattr(FD, name)
        monkeypatch.setattr(FD, name, lambda *a, _o=orig, _n=name:
                            (calls.append(_n), _o(*a))[1])
    x, w, b, dy = (torch.from_numpy(a) for a in _dense_inputs(rng, 6, 5, 4))
    x.requires_grad_("x" in needs)
    w.requires_grad_("w" in needs)
    b.requires_grad_("b" in needs)
    FD.fused_dense(x, w, b).backward(dy)
    assert calls.count("dense_dx") == ("x" in needs)
    assert calls.count("dense_dw_db") == ("w" in needs or "b" in needs)
    assert (x.grad is not None) == ("x" in needs)
    assert (w.grad is not None) == ("w" in needs)
    assert (b.grad is not None) == ("b" in needs)


def test_fused_dense_takes_an_expanded_cotangent(rng):
    """``mean``'s backward hands in a gradient with zero strides."""
    x, w, b, _ = _dense_inputs(rng, 9, 7, 5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    FD.fused_dense(*leaves).mean().backward()
    plain = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    torch.relu(plain[0] @ plain[1] + plain[2]).mean().backward()
    for a, p in zip(leaves, plain):
        torch.testing.assert_close(a.grad, p.grad, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_fused", [None, True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_dense_dispatch_on_cpu_matches_reference(use_fused, relu, rng):
    """Leading dims flatten to rows; a CPU tensor gets the plain version
    whatever `use_fused` says, and no kernel launch is counted."""
    jax, _, _ = _reference()
    from repro.kernels import dispatch as JD
    x, w, b, _ = _dense_inputs(rng, 6, 16, 29)
    x = x.reshape(2, 3, 16)
    before = FD.dense_forward.launches
    got = D.dense(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(b), relu=relu, use_fused=use_fused)
    assert FD.dense_forward.launches == before
    want = JD.dense(jax.numpy.asarray(x), w, b, relu=relu, use_fused=False)
    assert got.shape == (2, 3, 29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_mlp_apply_rejects_fused_non_relu_and_honors_it_otherwise(rng):
    """The reference's contract: the kernels hard-wire ReLU, so another
    activation raises on an explicit use_fused=True and takes the plain
    path otherwise (never silently replaced by ReLU)."""
    ws, bs = _mlp(rng, [8, 16, 16, 4])
    params = {"layers": [{"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
                         for w, b in zip(ws, bs)]}
    x = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="relu"):
        L.mlp_apply(params, x, activation=torch.tanh, use_fused=True)
    h = x
    for p in params["layers"][:-1]:
        h = torch.tanh(h @ p["w"] + p["b"])
    want = h @ params["layers"][-1]["w"] + params["layers"][-1]["b"]
    for use_fused in (None, False):
        got = L.mlp_apply(params, x, activation=torch.tanh,
                          use_fused=use_fused)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the dense kernels' 3xTF32 split, emulated on the CPU
# ---------------------------------------------------------------------------
def tf32_rna(a):
    """float32 -> TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` rounds:
    to nearest, ties away from zero (on the magnitude bits)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_read(a):
    """What a tensor core reads of a float32 operand: its top 19 bits."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a, b, terms):
    """a @ b as the dense kernels' tensor cores form it, each product
    exact in float64: big·big alone (1xTF32) or with big·small and
    small·big (3xTF32; small·small dropped).  big = tf32_rna(v), small =
    v - big taken in float32 and read by the tensor cores as TF32, as in
    the kernel."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    a_small, b_small = _tf32_read(a - a_big), _tf32_read(b - b_big)
    f = lambda u: u.astype(np.float64)
    out = f(a_big) @ f(b_big)
    if terms == 3:
        out += f(a_small) @ f(b_big) + f(a_big) @ f(b_small)
    return out


def _split_operands(kind, m, k, n, seed=0):
    """(A, B, bias) of the forward x·W + b, dx = g·Wᵀ or dW = xᵀ·g at a
    dense layer (M, K, N), with g = dy ⊙ [y > 0] and W He-scaled, as the
    training step feeds them; bias is None for the backward pair."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * (2.0 / k) ** 0.5).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    y = rng.normal(size=(m, n)).astype(np.float32)
    g = dy * (y > 0).astype(np.float32)
    if kind == "forward":
        return x, w, (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    return ((g, w.T) if kind == "dx" else (x.T, g)) + (None,)


def _tf32_layer(x, w, b, relu):
    """The forward kernel's layer as its tile forms it: the 3xTF32 sum
    rounded to float32, then + b in float32, then ReLU (the order of
    `_fused_dense_kernel`'s epilogue)."""
    y = _tf32_product(x, w, 3).astype(np.float32) + b
    return np.maximum(y, np.float32(0)) if relu else y


def _scaled_err(got, want):
    return float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max()))


#: (M, K, N): a hidden layer with M cut to 256, the narrow layers of
#: Algorithm 1 (D's first 81 -> 2048, G's head -> 73, D's head -> 2) and a
#: width no 4-float copy divides
SPLIT_SHAPES = [(256, 2048, 2048), (256, 81, 2048), (256, 2048, 73),
                (256, 2048, 2), (257, 81, 37)]


@pytest.mark.parametrize("kind", ["dx", "dw", "forward"])
@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
def test_3xtf32_split_is_float32_accurate(kind, m, k, n):
    """The three-term TF32 product within 1e-6·max(1, max|ref|) of the
    float64 product: the split costs the kernels nothing against their
    1e-4 tolerance.  The forward also adds the bias and applies ReLU in
    the kernel's order, against relu(x·W + b) in float64."""
    a, b, bias = _split_operands(kind, m, k, n)
    want = a.astype(np.float64) @ b.astype(np.float64)
    if bias is None:
        got = _tf32_product(a, b, 3)
    else:
        got = _tf32_layer(a, b, bias, True)
        want = np.maximum(want + bias, 0.0)
    assert _scaled_err(got, want) <= 1e-6


@pytest.mark.parametrize("m,widths", [(64, [16, 512, 512, 512, 29]),
                                      (64, [16, 256, 256, 73])])
def test_3xtf32_whole_mlp_is_float32_accurate(m, widths):
    """The whole-MLP chain layer by layer as the tile forms it (hidden
    ReLU, linear head; the serving path's 64 rows, input 16, heads 29 and
    73) within 1e-6·max(1, max|ref|) of the chain in float64."""
    rng = np.random.default_rng(0)
    ws, bs = _mlp(rng, widths)
    x = rng.normal(size=(m, widths[0])).astype(np.float32)
    got, want = x, x.astype(np.float64)
    for i, (w, b) in enumerate(zip(ws, bs)):
        last = i == len(ws) - 1
        got = _tf32_layer(got, w, b, not last)
        want = want @ w.astype(np.float64) + b
        want = want if last else np.maximum(want, 0.0)
    assert got.shape == (m, widths[-1])
    assert _scaled_err(got, want) <= 1e-6


def test_1xtf32_misses_the_kernel_tolerance():
    """Why the split: one TF32 product of dx-shaped operands at a hidden
    layer (M cut to 256) misses the 1e-4 tolerance, and the split gains
    over two orders of magnitude on it."""
    a, b, _ = _split_operands("dx", 256, 2048, 2048)
    want = a.astype(np.float64) @ b.astype(np.float64)
    one = _scaled_err(_tf32_product(a, b, 1), want)
    three = _scaled_err(_tf32_product(a, b, 3), want)
    assert one > 1e-4
    assert three < one / 100


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def h100():
    """Skip unless an sm_90 card is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a (H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,widths", SHAPES + [
    (129, [16, 33, 64, 73]),         # three row tiles, ragged
    (300, [16, 2048, 2048, 29]),     # K split into 8 slices
    (64, [16, 1000, 520, 73]),       # K split into 3 and 2 uneven slices
    (64, [16, 2048, 2048, 29]),      # the 64-row tile, split
    (65, [16, 300, 29]),             # the 128-row tile from 65 rows
    (1024, [16, 2048, 2048, 73]),    # the 128-row tile, split
])
def test_cuda_kernel_matches_plain(m, widths, h100, rng):
    ws, bs = _mlp(rng, widths)
    x = torch.from_numpy(rng.normal(size=(m, widths[0])).astype(np.float32))
    tw = [torch.from_numpy(w).to(h100) for w in ws]
    tb = [torch.from_numpy(b).to(h100) for b in bs]
    before = FM.fused_mlp.launches
    got = FM.fused_mlp(x.to(h100), tw, tb)
    want = ref.fused_mlp(x.to(h100), tw, tb)
    torch.cuda.synchronize()
    assert FM.fused_mlp.launches == before + 1
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_kernel_rows_do_not_depend_on_the_batch(h100, rng):
    """The K slices depend on K alone, and every tile and way of summing
    them does a row's arithmetic the same, so a row's bits are the same
    in a 1024-row call (slices folded in the block), a 300-row one
    (128-row tile, split across the grid), a 64-row and a 3-row one
    (64-row tile): what keeps a task's Selection independent of its
    batch."""
    ws, bs = _mlp(rng, [16, 2048, 2048, 73])
    x = torch.from_numpy(rng.normal(size=(1024, 16)).astype(np.float32))
    tw = [torch.from_numpy(w).to(h100) for w in ws]
    tb = [torch.from_numpy(b).to(h100) for b in bs]
    full = FM.fused_mlp(x.to(h100), tw, tb)
    mid = FM.fused_mlp(x[:300].contiguous().to(h100), tw, tb)
    tasks = FM.fused_mlp(x[:64].contiguous().to(h100), tw, tb)
    part = FM.fused_mlp(x[5:8].contiguous().to(h100), tw, tb)
    assert torch.equal(full[:300], mid)
    assert torch.equal(full[:64], tasks)
    assert torch.equal(full[5:8], part)
    assert torch.equal(tasks[5:8], part)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 1024])
def test_cuda_kernel_gives_the_same_bits_twice(m, h100, rng):
    """No atomics: two calls of the whole MLP give identical bits."""
    ws, bs = _mlp(rng, [16, 2048, 2048, 29])
    x = torch.from_numpy(rng.normal(size=(m, 16)).astype(np.float32))
    x, tw, tb = (x.to(h100), [torch.from_numpy(w).to(h100) for w in ws],
                 [torch.from_numpy(b).to(h100) for b in bs])
    assert torch.equal(FM.fused_mlp(x, tw, tb), FM.fused_mlp(x, tw, tb))


@pytest.mark.cuda
@pytest.mark.parametrize("m,widths", [(64, [16, 2048, 2048, 2048, 29]),
                                      (1024, [16, 2048, 2048, 73]),
                                      (3, [16, 1000, 520, 73])])
def test_cuda_whole_mlp_is_float32_accurate(m, widths, h100, rng):
    """The whole-MLP kernel no further from the float64 chain than 4x the
    plain float32 chain is, plus 1e-6·scale."""
    ws, bs = _mlp(rng, widths)
    x = torch.from_numpy(rng.normal(size=(m, widths[0])).astype(np.float32))
    x, tw, tb = (x.to(h100), [torch.from_numpy(w).to(h100) for w in ws],
                 [torch.from_numpy(b).to(h100) for b in bs])
    want = x.double()
    for i, (w, b) in enumerate(zip(tw, tb)):
        want = want @ w.double() + b.double()
        want = want if i == len(tw) - 1 else torch.relu(want)
    got, plain = FM.fused_mlp(x, tw, tb), ref.fused_mlp(x, tw, tb)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    e_kernel = float((got.double() - want).abs().max())
    e_plain = float((plain.double() - want).abs().max())
    assert e_kernel <= 4 * e_plain + 1e-6 * scale, \
        f"{e_kernel} from float64, plain {e_plain}"


@pytest.mark.cuda
@pytest.mark.parametrize("m,widths", [(64, [16, 2048, 2048, 2048, 73]),
                                      (13, [16, 33, 64, 29])])
def test_cuda_whole_mlp_gradient_matches_plain(m, widths, h100, rng):
    """``mlp_apply_chained`` on the card is differentiable: its gradients
    of x, every w and every b within 1e-4·max(1, max|g_ref|) of the plain
    chain's (TF32 off), with the backward on the dense kernels (one
    forward, one dx and one dW/db a layer: x needs its gradient too),
    counted in their wrappers."""
    ws, bs = _mlp(rng, widths)
    x = rng.normal(size=(m, widths[0])).astype(np.float32)
    dy = torch.from_numpy(rng.normal(size=(m, widths[-1])).astype(np.float32))
    n = len(ws)

    def grads(fn):
        leaves = [torch.from_numpy(a).to(h100).requires_grad_()
                  for a in (x, *ws, *bs)]
        params = {"layers": [{"w": w, "b": b} for w, b in
                             zip(leaves[1:1 + n], leaves[1 + n:])]}
        y = fn(params, leaves[0])
        return torch.autograd.grad(y, leaves, dy.to(h100))

    want = grads(lambda p, x_: L.mlp_apply_chained(p, x_, use_fused=False))
    before = (FM.fused_mlp.launches, FD.dense_forward.launches,
              FD.dense_dx.launches, FD.dense_dw_db.launches)
    got = grads(L.mlp_apply_chained)
    torch.cuda.synchronize()
    after = (FM.fused_mlp.launches, FD.dense_forward.launches,
             FD.dense_dx.launches, FD.dense_dw_db.launches)
    assert [a - b for a, b in zip(after, before)] == [1, n, n, n]
    for i, (g, w_) in enumerate(zip(got, want)):
        scale = max(1.0, float(w_.abs().max()))
        err = float((g - w_).abs().max())
        assert err <= 1e-4 * scale, f"input {i}: {err}"


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(h100):
    ws = [torch.zeros(4, 8, device=h100), torch.zeros(8, 3, device=h100)]
    bs = [torch.zeros(8, device=h100), torch.zeros(3, device=h100)]
    x = torch.zeros(5, 4, device=h100)
    with pytest.raises(TypeError):
        FM.fused_mlp(x.double(), ws, bs)
    with pytest.raises(ValueError):
        FM.fused_mlp(torch.zeros(5, 6, device=h100), ws, bs)     # width
    with pytest.raises(ValueError):
        FM.fused_mlp(torch.zeros(4, 5, device=h100).t(), ws, bs)  # layout
    with pytest.raises(ValueError):
        FM.fused_mlp(x, [ws[0].cpu(), ws[1]], bs)                # device


#: (M, K, N) on the card: Algorithm 1's own (batch 1024; hidden 2048 ->
#: 2048, G's head 2048 -> 73, D's first layer 81 -> 2048, D's head
#: 2048 -> 2) and ragged small ones, split and unsplit
CUDA_DENSE_SHAPES = DENSE_SHAPES + [
    (1024, 2048, 2048), (1024, 2048, 73), (1024, 81, 2048), (1024, 2048, 2),
    (129, 33, 64), (300, 16, 2048), (64, 1000, 520),
    (257, 81, 37), (1024, 37, 2),    # 4-byte copies on every operand
]


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _close(got, want, name):
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert got.shape == want.shape, name
    assert err <= 1e-4 * scale, f"{name}: {err} > {1e-4 * scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,k,n", CUDA_DENSE_SHAPES)
def test_cuda_dense_kernels_match_plain(m, k, n, relu, h100, rng):
    x, w, b, dy = _on(h100, *_dense_inputs(rng, m, k, n))
    counts = (FD.dense_forward.launches, FD.dense_dx.launches,
              FD.dense_dw_db.launches)
    y = FD.dense_forward(x, w, b, relu)
    y_ref = ref.fused_dense(x, w, b, relu)
    _close(y, y_ref, "y")
    dx = FD.dense_dx(dy, y_ref, w, relu)
    dw, db = FD.dense_dw_db(x, dy, y_ref, relu)
    p_dw, p_db = ref.dense_dw_db(x, dy, y_ref, relu)
    torch.cuda.synchronize()
    _close(dx, ref.dense_dx(dy, y_ref, w, relu), "dx")
    _close(dw, p_dw, "dw")
    _close(db, p_db, "db")
    assert (FD.dense_forward.launches, FD.dense_dx.launches,
            FD.dense_dw_db.launches) == tuple(c + 1 for c in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1024, 2048, 73), (1024, 81, 2048),
                                   (37, 29, 73), (1024, 2048, 2048)])
def test_cuda_dense_kernels_give_the_same_bits_twice(m, k, n, h100, rng):
    """No atomics: two calls give identical bits (split reductions sum
    their slices in order, db is summed by one block per column tile)."""
    x, w, b, dy = _on(h100, *_dense_inputs(rng, m, k, n))
    y = FD.dense_forward(x, w, b, True)
    for fn, args in ((FD.dense_forward, (x, w, b, True)),
                     (FD.dense_dx, (dy, y, w, True)),
                     (FD.dense_dw_db, (x, dy, y, True))):
        a, c = fn(*args), fn(*args)
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        c if isinstance(c, tuple) else (c,)):
            assert torch.equal(u, v), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,k,n", [(1024, 2048, 2048), (1024, 81, 2048),
                                   (1024, 2048, 73)])
def test_cuda_dense_backward_is_float32_accurate(m, k, n, relu, h100, rng):
    """The tensor-core backward kernels are no further from a float64
    product than 4x the plain float32 product is, plus 1e-6·scale: what a
    single-pass TF32 kernel (~1e3x further) cannot meet."""
    x, w, b, dy = _on(h100, *_dense_inputs(rng, m, k, n))
    y = ref.fused_dense(x, w, b, relu)
    g64 = (dy * (y > 0) if relu else dy).double()
    want = {"dx": g64 @ w.double().t(), "dw": x.double().t() @ g64,
            "db": g64.sum(0)}
    got = dict(zip(("dw", "db"), FD.dense_dw_db(x, dy, y, relu)),
               dx=FD.dense_dx(dy, y, w, relu))
    plain = dict(zip(("dw", "db"), ref.dense_dw_db(x, dy, y, relu)),
                 dx=ref.dense_dx(dy, y, w, relu))
    torch.cuda.synchronize()
    for name, t in want.items():
        scale = max(1.0, float(t.abs().max()))
        e_kernel = float((got[name].double() - t).abs().max())
        e_plain = float((plain[name].double() - t).abs().max())
        assert e_kernel <= 4 * e_plain + 1e-6 * scale, \
            f"{name}: {e_kernel} from float64, plain {e_plain}"


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,k,n", [(1024, 2048, 2048), (1024, 2048, 73),
                                   (1024, 81, 2048), (1024, 2048, 2)])
def test_cuda_dense_forward_is_float32_accurate(m, k, n, relu, h100, rng):
    """The tensor-core forward kernel no further from [relu](x·W + b) in
    float64 than 4x the plain float32 version is, plus 1e-6·scale."""
    x, w, b, _ = _on(h100, *_dense_inputs(rng, m, k, n))
    want = x.double() @ w.double() + b.double()
    want = torch.relu(want) if relu else want
    got = FD.dense_forward(x, w, b, relu)
    plain = ref.fused_dense(x, w, b, relu)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    e_kernel = float((got.double() - want).abs().max())
    e_plain = float((plain.double() - want).abs().max())
    assert e_kernel <= 4 * e_plain + 1e-6 * scale, \
        f"{e_kernel} from float64, plain {e_plain}"


@pytest.mark.cuda
def test_cuda_fused_dense_backward_launches_its_kernels(h100, rng):
    x, w, b, dy = _on(h100, *_dense_inputs(rng, 64, 37, 73))
    w.requires_grad_()
    b.requires_grad_()
    counts = (FD.dense_dx.launches, FD.dense_dw_db.launches)
    FD.fused_dense(x, w, b).backward(dy)            # x needs no gradient
    assert (FD.dense_dx.launches, FD.dense_dw_db.launches) == \
        (counts[0], counts[1] + 1)
    plain_w, plain_b = (t.detach().clone().requires_grad_() for t in (w, b))
    torch.relu(x @ plain_w + plain_b).backward(dy)
    _close(w.grad, plain_w.grad, "dw")
    _close(b.grad, plain_b.grad, "db")


@pytest.mark.cuda
def test_cuda_dense_wrappers_reject_what_the_kernels_do_not_take(h100):
    x = torch.zeros(5, 4, device=h100)
    w = torch.zeros(4, 3, device=h100)
    b = torch.zeros(3, device=h100)
    y = torch.zeros(5, 3, device=h100)
    with pytest.raises(TypeError):
        FD.dense_forward(x.double(), w, b, True)
    with pytest.raises(ValueError):
        FD.dense_forward(torch.zeros(5, 6, device=h100), w, b, True)  # K
    with pytest.raises(ValueError):
        FD.dense_forward(x, w, torch.zeros(4, device=h100), True)     # bias
    with pytest.raises(ValueError):
        FD.dense_dx(torch.zeros(3, 5, device=h100).t(), y, w, True)   # layout
    with pytest.raises(ValueError):
        FD.dense_dw_db(x, y.cpu(), y, True)                           # device
    with pytest.raises(ValueError):
        FD.dense_dw_db(x, y, torch.zeros(5, 4, device=h100), True)    # y shape


# ---------------------------------------------------------------------------
# flash attention: the plain version against the reference (CPU)
# ---------------------------------------------------------------------------
def _flash_reference():
    jax, _, JREF = _reference()
    from repro.kernels import flash_attention as JFA
    return jax, JFA, JREF


def _qkv(rng, b, h, hkv, sq, sk, d):
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_plain_flash_matches_pallas_interpret(h, hkv, causal, window, rng):
    """The grid of the reference's own kernel test: the plain version
    within 2e-4 of the Pallas kernel in interpret mode and of the jnp
    oracle."""
    jax, JFA, JREF = _flash_reference()
    q, k, v = _qkv(rng, 2, h, hkv, 256, 256, 32)
    got = ref.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window).numpy()
    jq, jk, jv = map(jax.numpy.asarray, (q, k, v))
    pallas = np.asarray(JFA.flash_attention(jq, jk, jv, causal=causal,
                                            window=window, bq=64, bk=64,
                                            interpret=True))
    oracle = np.asarray(JREF.flash_attention(jq, jk, jv, causal=causal,
                                             window=window))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_plain_flash_dtypes_match_pallas_interpret(dtype, tol, rng):
    jax, JFA, _ = _flash_reference()
    q, k, v = _qkv(rng, 1, 4, 2, 128, 128, 64)
    jq, jk, jv = (jax.numpy.asarray(a, getattr(jax.numpy, dtype))
                  for a in (q, k, v))
    pallas = JFA.flash_attention(jq, jk, jv, bq=64, bk=64, interpret=True)
    # the same rounded inputs on both sides
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    got = ref.flash_attention(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(pallas, np.float32), rtol=tol,
                               atol=tol)


def test_plain_flash_q_offset_matches_pallas_interpret(rng):
    """A continued prefill: q rows 64.. at q_offset 64 against the whole
    k/v, as the reference's kernel computes it, and equal to the rows of
    the full pass."""
    jax, JFA, _ = _flash_reference()
    q, k, v = _qkv(rng, 1, 4, 2, 128, 128, 32)
    jq, jk, jv = map(jax.numpy.asarray, (q, k, v))
    pallas = np.asarray(JFA.flash_attention(jq[:, :, 64:], jk, jv,
                                            q_offset=64, window=48, bq=32,
                                            bk=32, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    part = ref.flash_attention(tq[:, :, 64:], tk, tv, q_offset=64, window=48)
    np.testing.assert_allclose(part.numpy(), pallas, rtol=2e-4, atol=2e-4)
    full = ref.flash_attention(tq, tk, tv, window=48)
    np.testing.assert_allclose(part.numpy(), full[:, :, 64:].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_fused", [None, True, False])
def test_flash_ops_on_cpu_take_the_plain_version(use_fused, rng):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 4, 1, 40, 40, 16))
    before = FA.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=9, use_fused=use_fused)
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, window=9),
                               rtol=0, atol=0)
    assert FA.flash_attention.launches == before


# ---------------------------------------------------------------------------
# the flash kernel's tensor-core arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
def _c_frags(c):
    """A 16 x 8 accumulator as the lanes hold it: lane (gid, tig) has
    (gid, 2tig), (gid, 2tig + 1), (gid + 8, 2tig), (gid + 8, 2tig + 1)."""
    return [(c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1])
            for g, t in (divmod(lane, 4) for lane in range(32))]


def _mma_tf32(a, b):
    """mma.m16n8k8 (TF32) of per-lane registers, placed as PTX lays them
    out: a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 (gid + 8,
    tig + 4); b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        B[t, g], B[t + 4, g] = b[lane]
    return A @ B


def _mma_bf16(a, b):
    """mma.m16n8k16 (bf16) of per-lane registers of two values each: a0
    (gid, 2tig + h), a1 (gid + 8, ...), a2 (gid, 2tig + 8 + h), a3;
    b0 (k = 2tig + h, n = gid), b1 (k = 2tig + 8 + h, n = gid)."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for h in (0, 1):
            A[g, 2 * t + h], A[g + 8, 2 * t + h] = a[lane][0][h], a[lane][1][h]
            A[g, 2 * t + 8 + h] = a[lane][2][h]
            A[g + 8, 2 * t + 8 + h] = a[lane][3][h]
            B[2 * t + h, g], B[2 * t + 8 + h, g] = b[lane][0][h], b[lane][1][h]
    return A @ B


def _ldmatrix_x4(smem, addr, trans):
    """ldmatrix .x4 (b16): lanes 8i..8i+7 give the rows of matrix i (8
    values from (row, col)); lane t gets of each matrix the pair at row
    t / 4, columns 2(t % 4) and + 1 (with .trans: at rows 2(t % 4) and + 1,
    column t / 4)."""
    regs = [[None] * 4 for _ in range(32)]
    for i in range(4):
        m = np.stack([smem[r, c:c + 8] for r, c in
                      (addr(lane) for lane in range(8 * i, 8 * i + 8))])
        for t in range(32):
            r, c = divmod(t, 4)
            regs[t][i] = ((m[2 * c, r], m[2 * c + 1, r]) if trans
                          else (m[r, 2 * c], m[r, 2 * c + 1]))
    return regs


def test_flash_tf32_fragments_take_the_keys_in_a_permuted_order(rng):
    """float32 P·V: the A fragment is the S accumulator as the lanes hold
    it (a = c0, c2, c1, c3) and V's B fragment reads rows 2tig and
    2tig + 1, so logical k = t is key 2t (t < 4) or 2(t - 4) + 1: the mma
    gives P·V (float64, to rounding), and the float32 sum over keys in
    that order is the natural order's up to float32 rounding."""
    p = rng.random((16, 8))
    v = rng.normal(size=(8, 8))
    a = [(c0, c2, c1, c3) for c0, c1, c2, c3 in _c_frags(p)]
    b = [(v[2 * t, g], v[2 * t + 1, g])
         for g, t in (divmod(lane, 4) for lane in range(32))]
    np.testing.assert_allclose(_mma_tf32(a, b), p @ v, rtol=1e-12,
                               atol=1e-12)
    order = [0, 2, 4, 6, 1, 3, 5, 7]
    p32, v32 = p.astype(np.float32), v.astype(np.float32)
    natural = np.zeros((16, 8), np.float32)
    permuted = np.zeros((16, 8), np.float32)
    for kn, kp in zip(range(8), order):
        natural += p32[:, kn, None] * v32[kn]
        permuted += p32[:, kp, None] * v32[kp]
    bound = 8 * np.finfo(np.float32).eps * (np.abs(p32) @ np.abs(v32))
    assert np.all(np.abs(natural - permuted) <= bound)


def test_flash_bf16_fragments_from_ldmatrix(rng):
    """bf16: Q's and K's fragments by ldmatrix, V's by ldmatrix .trans,
    at the kernel's addresses (one warp's 16 rows, 16 keys, D = 32, two
    8-column n-tiles), and P's A fragment from two n-tiles of S's
    accumulator: the mma's give Q·Kᵀ and P·V."""
    q, k = rng.normal(size=(16, 32)), rng.normal(size=(16, 32))
    v, p = rng.normal(size=(16, 16)), rng.random((16, 16))
    s = np.zeros((16, 16))
    for kk in (0, 16):                       # scores(): two k-steps
        a = _ldmatrix_x4(q, lambda l: (l % 8 + (l // 8 & 1) * 8,
                                       kk + (l // 8 >> 1) * 8), False)
        b = _ldmatrix_x4(k, lambda l: (l % 8 + (l // 8 >> 1) * 8,
                                       kk + (l // 8 & 1) * 8), False)
        s[:, 0:8] += _mma_bf16(a, [(r[0], r[1]) for r in b])
        s[:, 8:16] += _mma_bf16(a, [(r[2], r[3]) for r in b])
    np.testing.assert_allclose(s, q @ k.T, rtol=1e-12, atol=1e-12)
    c0, c1 = _c_frags(p[:, 0:8]), _c_frags(p[:, 8:16])
    a = [((x[0], x[1]), (x[2], x[3]), (y[0], y[1]), (y[2], y[3]))
         for x, y in zip(c0, c1)]
    b = _ldmatrix_x4(v, lambda l: (l % 8 + (l // 8 & 1) * 8,
                                   (l // 8 >> 1) * 8), True)
    o = np.concatenate([_mma_bf16(a, [(r[0], r[1]) for r in b]),
                        _mma_bf16(a, [(r[2], r[3]) for r in b])], axis=1)
    np.testing.assert_allclose(o, p @ v, rtol=1e-12, atol=1e-12)


def _rz(x):
    """float64 -> float32 rounded toward zero, as the tensor cores add
    into their float32 accumulator."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x),
                    np.nextafter(f, np.float32(0)), f)


def _bf16(x):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _flash_emulated(q, k, v, bk, kind):
    """One head of causal attention as the kernel forms it: key tiles of
    bk, the online softmax in float32, every mma an exact dot product
    added to its chain's accumulator toward zero.  kind "tf32": Q·Kᵀ and
    P·V in 3xTF32 (small·big, big·small, big·big), S in 32-wide d stages
    and P·V over a tile in fresh chains, added in float32 (P·V's keys in
    the kernel's order); "bf16": Q·Kᵀ in one chain of 16-wide steps, P
    split into bf16 hi + lo, lo·V then hi·V; "bf16 single": P rounded to
    bf16 once (what the split avoids).  Returns the float32 output
    before any rounding to q's type."""
    f64 = lambda x: x.astype(np.float64)
    sq, d = q.shape
    parts = lambda x: (_tf32_read(x - tf32_rna(x)), tf32_rna(x))
    if kind == "tf32":
        (qs, qb), (ks, kb), (vs, vb) = parts(q), parts(k), parts(v)
    m = np.full(sq, -1e30, np.float32)
    l = np.zeros(sq, np.float32)
    o = np.zeros((sq, d), np.float32)
    scale = np.float32(1 / d ** 0.5)
    qpos = np.arange(sq)[:, None]
    for k0 in range(0, sq, bk):
        ks_ = slice(k0, k0 + bk)
        s = np.zeros((sq, bk), np.float32)
        if kind == "tf32":
            for d0 in range(0, d, 32):
                st = np.zeros((sq, bk), np.float32)
                for kk in range(d0, min(d0 + 32, d), 8):
                    dd = slice(kk, kk + 8)
                    for a, b in ((qs, kb), (qb, ks), (qb, kb)):
                        st = _rz(st + f64(a[:, dd]) @ f64(b[ks_, dd]).T)
                s = s + st
        else:
            for kk in range(0, d, 16):
                dd = slice(kk, kk + 16)
                s = _rz(s + f64(q[:, dd]) @ f64(k[ks_, dd]).T)
        keep = qpos >= np.arange(k0, k0 + bk)[None, :]
        s = np.where(keep, s * scale, np.float32(-1e30))
        m_new = np.maximum(m, s.max(1))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new[:, None])
        l = l * alpha + p.sum(1, dtype=np.float32)
        m = m_new
        t = np.zeros((sq, d), np.float32)
        if kind == "tf32":
            ps, pb = parts(p)
            for kk in range(0, bk, 8):
                idx = k0 + kk + np.array([0, 2, 4, 6, 1, 3, 5, 7])
                for a, b in ((ps, vb), (pb, vs), (pb, vb)):
                    t = _rz(t + f64(a[:, idx - k0]) @ f64(b[idx]))
        else:
            hi = _bf16(p)
            terms = (hi,) if kind == "bf16 single" else (_bf16(p - hi), hi)
            for kk in range(0, bk, 16):
                for a in terms:
                    t = _rz(t + f64(a[:, kk:kk + 16])
                            @ f64(v[k0 + kk:k0 + kk + 16]))
        o = o * alpha[:, None] + t
    return o / np.maximum(l, np.float32(1e-30))[:, None]


def _attention64(q, k, v):
    s = q.astype(np.float64) @ k.astype(np.float64).T / q.shape[1] ** 0.5
    s = np.where(np.tril(np.ones(s.shape, bool)), s, -1e30)
    p = np.exp(s - s.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)) @ v.astype(np.float64)


def _plain32(q, k, v):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))[None, None]
    return ref.flash_attention(t(q), t(k), t(v))[0, 0].numpy()


@pytest.mark.parametrize("s,d,bk", [(128, 64, 64), (96, 256, 32)])
def test_flash_3xtf32_emulation_is_float32_accurate(s, d, bk):
    """The float32 kernel's arithmetic (3xTF32 S in 32-wide stages, the
    online softmax, 3xTF32 P·V in per-tile chains) within 2x the plain
    float32 attention's error from float64 attention."""
    rng = np.random.default_rng(s + d)
    q, k, v = (rng.normal(size=(s, d)).astype(np.float32) for _ in range(3))
    want = _attention64(q, k, v)
    got = _flash_emulated(q, k, v, bk, "tf32")
    plain = _plain32(q, k, v)
    err, err_plain = (float(np.abs(x - want).max()) for x in (got, plain))
    assert err <= 2 * err_plain, (err, err_plain)


@pytest.mark.parametrize("s,d,bk", [(128, 64, 64), (96, 256, 32)])
def test_flash_bf16_split_p_emulation_is_float32_accurate(s, d, bk):
    """The bf16 kernel's arithmetic on bf16 inputs (exact products, P =
    hi + lo): its bf16 output within 2x the plain version's bf16 output
    error from float64 attention of the same inputs, and its float32
    output before the last rounding within 2^-16·scale of it (P kept to
    ~16 bits), where one bf16 rounding of P loses more than 2^-11."""
    rng = np.random.default_rng(s + d)
    q, k, v = (_bf16(rng.normal(size=(s, d))) for _ in range(3))
    want = _attention64(q, k, v)
    scale = max(1.0, float(np.abs(want).max()))
    split = _flash_emulated(q, k, v, bk, "bf16")
    err = float(np.abs(_bf16(split) - want).max())
    err_plain = float(np.abs(_bf16(_plain32(q, k, v)) - want).max())
    assert err <= 2 * err_plain, (err, err_plain)
    assert float(np.abs(split - want).max()) <= 2.0 ** -16 * scale
    single = _flash_emulated(q, k, v, bk, "bf16 single")
    assert float(np.abs(single - want).max()) > 2.0 ** -11 * scale


# ---------------------------------------------------------------------------
# flash attention on the card
# ---------------------------------------------------------------------------
#: (B, H, Hkv, Sq, Sk, D, causal, window, q_offset): every head dim, GQA
#: groups 1/4/8, lengths no tile divides, the band's edges, a continued
#: prefill, Sq != Sk both ways
CUDA_FLASH_CASES = [
    (1, 8, 2, 512, 512, 64, True, None, 0),      # bench_kernels.py's shape
    (2, 4, 1, 1000, 1000, 256, True, None, 0),   # gemma3 global, ragged
    (2, 4, 1, 1000, 1000, 256, True, 128, 0),    # gemma3 local, ragged
    (1, 4, 4, 77, 77, 16, True, 9, 0),
    (1, 4, 2, 130, 130, 32, False, None, 0),
    (1, 2, 2, 200, 333, 128, False, 50, 0),
    (1, 4, 1, 100, 300, 128, True, None, 200),   # q rows 200..299
    (1, 4, 1, 64, 512, 256, True, 100, 448),
    (3, 2, 1, 1, 1, 64, True, None, 0),
    (2, 4, 2, 70, 70, 16, False, None, 0),
    (1, 2, 1, 33, 97, 32, True, 20, 64),         # q rows 64..96, ragged
    (1, 8, 8, 129, 129, 64, True, 31, 0),
    (1, 4, 2, 300, 300, 128, True, None, 0),
    (1, 4, 1, 200, 1000, 256, False, None, 0),
    (2, 25, 5, 4096, 4096, 64, True, None, 0),   # hymba-1.5b global
    (2, 25, 5, 4096, 4096, 64, True, 1024, 0),   # hymba-1.5b local
]


def _flash_close(got, want, tol, name):
    scale = max(1.0, float(want.abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert err <= tol * scale, f"{name}: {err} > {tol * scale}"


def _within_one_bf16_ulp(got, want, name):
    """bf16 outputs of two float32-accurate computations: within one bf16
    ulp (at the larger of the two) plus 1e-5·scale, element by element."""
    g, w = got.float(), want.float()
    scale = max(1.0, float(w.abs().max()))
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    excess = float(((g - w).abs() - ulp).max())
    assert excess <= 1e-5 * scale, f"{name}: {excess} past one bf16 ulp"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", CUDA_FLASH_CASES)
def test_cuda_flash_matches_plain(case, dtype, tol, h100, rng):
    from repro_torch.kernels import flash_attention as FA
    b, h, hkv, sq, sk, d, causal, window, q_offset = case
    q, k, v = (t.to(h100, dtype) for t in map(
        torch.from_numpy, _qkv(rng, b, h, hkv, sq, sk, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, **kw)
    again = FA.flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 2
    assert bool(torch.isfinite(got.float()).all())
    _flash_close(got, want, tol, str(case))
    if dtype == torch.bfloat16:
        _within_one_bf16_ulp(got, want, str(case))
    assert torch.equal(got, again), "two calls differ"


@pytest.mark.cuda
def test_cuda_flash_reads_strided_views(h100, rng):
    """(B, S, H, D) tensors passed as transpose(1, 2) views, v a slice of
    a fused kv projection: read in place, the output in q's layout."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.nn import attention as A
    b, s, h, hkv, d = 2, 300, 4, 1, 256
    q = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(b, s, 2 * hkv, d)).astype(
        np.float32))
    q, kv = q.to(h100), kv.to(h100)
    k, v = kv[:, :, :hkv], kv[:, :, hkv:]
    got = A.flash_attention(q, k, v, window=64)
    assert got.is_contiguous()
    want = A.attention_reference(q, k, v, window=64)
    _flash_close(got, want, 1e-4, "strided")
    torch.testing.assert_close(
        FA.flash_attention(q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), window=64),
        got.transpose(1, 2), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_flash_rejects_what_the_kernel_does_not_take(h100):
    from repro_torch.kernels import flash_attention as FA
    q = torch.zeros(1, 4, 8, 64, device=h100)
    k = torch.zeros(1, 2, 8, 64, device=h100)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(torch.zeros(1, 4, 8, 48, device=h100),
                           torch.zeros(1, 2, 8, 48, device=h100),
                           torch.zeros(1, 2, 8, 48, device=h100))
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        FA.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError):
        FA.flash_attention(q, torch.zeros(1, 3, 8, 64, device=h100), k)
    with pytest.raises(ValueError):                         # last dim strided
        FA.flash_attention(q, k, torch.zeros(1, 2, 64, 8, device=h100)
                           .transpose(2, 3))
    with pytest.raises(ValueError):                         # device
        FA.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError):                  # rows 8-byte aligned
        kb = torch.zeros(1, 2, 8, 68, device=h100, dtype=torch.bfloat16)
        FA.flash_attention(q.bfloat16(), kb[..., :64], kb[..., :64])


#: (B, H, Hkv, S, D, window): the Function's blocks of 512 query rows,
#: partial last blocks, every GQA group shape, a window inside a block
CUDA_FLASH_GRAD_CASES = [
    (2, 8, 8, 300, 64, None),
    (1, 4, 1, 700, 256, 100),
    (1, 4, 2, 513, 128, None),
    (1, 4, 4, 64, 16, 9),
    (1, 2, 1, 1100, 32, 600),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_FLASH_GRAD_CASES)
def test_cuda_flash_function_matches_plain(case, h100, rng):
    """``FlashAttentionFn`` on the card (the kernel's forward with lse,
    the blocked torch-ops backward) against the plain attention under
    torch's autograd, float32: out, dq, dk and dv within 1e-4 of max(1,
    max|plain|); the kernel's out the same bits with and without lse;
    lse within 1e-5 of max(1, |lse|) of the plain version's."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.nn import attention as A
    b, h, hkv, s, d, window = case
    arrays = (rng.normal(size=(b, s, h, d)), rng.normal(size=(b, s, hkv, d)),
              rng.normal(size=(b, s, hkv, d)), rng.normal(size=(b, s, h, d)))
    q, k, v, do = (torch.tensor(a, dtype=torch.float32, device=h100)
                   for a in arrays)
    grads = {}
    for route, fused in (("kernel", None), ("plain", False)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = FA.flash_attention.lse_launches
        out = A.flash_attention(*leaves, window=window, use_fused=fused)
        out.backward(do)
        torch.cuda.synchronize()
        assert FA.flash_attention.lse_launches == before + (route == "kernel")
        grads[route] = [out.detach()] + [t.grad for t in leaves]
    for name, got, want in zip(("out", "dq", "dk", "dv"), grads["kernel"],
                               grads["plain"]):
        assert bool(torch.isfinite(got).all()), name
        _flash_close(got, want, 1e-4, f"{case} {name}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o_lse, lse = FA.flash_attention(qt, kt, vt, window=window,
                                    return_lse=True)
    assert torch.equal(o_lse, FA.flash_attention(qt, kt, vt, window=window))
    _, want_lse = ref.flash_attention(qt, kt, vt, window=window,
                                      return_lse=True)
    err = (lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-5, f"{case} lse {float(err.max())}"


#: (B, H, Hkv, Sq, Sk, D): whisper's attention shapes cut small, all
#: without a mask: the encoder's (a ragged last key tile), the
#: cross-attention's Sq < Sk, decode's one query, and whisper-small's own
#: cross-attention (448 queries against 1500 frames)
CUDA_FLASH_NONCAUSAL_CASES = [(2, 4, 4, 200, 200, 64),
                              (2, 4, 4, 56, 200, 64),
                              (2, 4, 4, 1, 200, 64),
                              (1, 12, 12, 448, 1500, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_FLASH_NONCAUSAL_CASES)
def test_cuda_flash_non_causal_at_whisper_shapes(case, h100, rng):
    """The kernel without a mask at Sq ≠ Sk and a ragged Sk, float32,
    with and without lse: out within 1e-4 of max(1, max|plain|), the same
    bits twice and with lse; lse within 1e-5 of max(1, |lse|) of the
    plain version's."""
    from repro_torch.kernels import flash_attention as FA
    b, h, hkv, sq, sk, d = case
    q, k, v = (t.to(h100) for t in map(
        torch.from_numpy, _qkv(rng, b, h, hkv, sq, sk, d)))
    got = FA.flash_attention(q, k, v, causal=False)
    again = FA.flash_attention(q, k, v, causal=False)
    o_lse, lse = FA.flash_attention(q, k, v, causal=False, return_lse=True)
    want, want_lse = ref.flash_attention(q, k, v, causal=False,
                                         return_lse=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _flash_close(got, want, 1e-4, str(case))
    assert torch.equal(got, again) and torch.equal(got, o_lse)
    err = (lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-5, f"{case} lse {float(err.max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("q_block", [512, 24])
def test_cuda_flash_function_at_sq_ne_sk(q_block, h100, rng):
    """``FlashAttentionFn`` without a mask, 56 queries against 200 keys
    (GQA 4:2), its backward in one block or in blocks of 24 (a ragged
    last one): out, dq, dk and dv within 1e-4 of max(1, max|plain|) of
    the plain attention under torch's autograd."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.nn import attention as A
    b, h, hkv, sq, sk, d = 2, 4, 2, 56, 200, 64
    arrays = (rng.normal(size=(b, sq, h, d)), rng.normal(size=(b, sk, hkv, d)),
              rng.normal(size=(b, sk, hkv, d)), rng.normal(size=(b, sq, h, d)))
    q, k, v, do = (torch.tensor(a, dtype=torch.float32, device=h100)
                   for a in arrays)
    grads = {}
    for route, fused in (("kernel", None), ("plain", False)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = FA.flash_attention.lse_launches
        out = A.flash_attention(*leaves, causal=False, use_fused=fused,
                                q_block=q_block)
        out.backward(do)
        torch.cuda.synchronize()
        assert FA.flash_attention.lse_launches == before + (route == "kernel")
        grads[route] = [out.detach()] + [t.grad for t in leaves]
    for name, got, want in zip(("out", "dq", "dk", "dv"), grads["kernel"],
                               grads["plain"]):
        assert bool(torch.isfinite(got).all()), name
        _flash_close(got, want, 1e-4, f"q_block {q_block} {name}")


@pytest.mark.cuda
def test_cuda_whisper_reduced_prefill_decode_and_gradient(h100):
    """Reduced whisper on the card: the prefill step (frames encoded) and
    4 decode steps with ``enc_out`` through the kernel against the plain
    route (``use_fused=False`` and the plain decode), within 1e-4 of
    max(1, max|plain|); 6 flash launches a prefill (2 encoder, 2 decoder,
    2 cross-attention), 2 a decode step (the cross-attention's one
    query); the gradient with ``frames`` within 1e-3 of each leaf's norm
    of the plain route's, 6 flash launches with lse."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import base as MB
    from repro_torch.optim import tree_leaves
    from repro_torch.train import step as TS
    m = configs.get_reduced("whisper-small")
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, h100)
    g = torch.Generator(device=h100).manual_seed(0)
    frames = torch.randn(2, 48, m.d_model, generator=g, device=h100) * 0.1
    toks = torch.randint(0, m.vocab, (2, 16), generator=g, device=h100)
    batch = {"frames": frames, "tokens": toks}
    before = FA.flash_attention.launches
    got = TS.make_prefill_step(m)(params, batch)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 6
    want = TS.make_prefill_step(m, use_fused=False)(params, batch)
    _flash_close(got, want, 1e-4, "prefill")
    enc = MB.encode(params, m, frames)
    dec = TS.make_decode_step(m)
    states = MB.init_decode_state(params, m, 2, 16)
    for t in range(4):
        before = FA.flash_attention.launches
        logits, states = dec(params, toks[:, t:t + 1], t, states, enc)
        assert FA.flash_attention.launches == before + 2
    full = MB.forward(params, m, toks[:, :4], use_fused=False,
                      enc_out=MB.encode(params, m, frames, use_fused=False))
    _flash_close(logits[:, 0], full[:, 3], 1e-4, "decode")
    batch["labels"] = torch.roll(toks, -1, 1)
    before = FA.flash_attention.lse_launches
    loss_k, g_k = TS.loss_and_grads(m, params, batch)
    assert FA.flash_attention.lse_launches == before + 6
    loss_p, g_p = TS.loss_and_grads(m, params, batch, use_fused=False)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for a, b_ in zip(tree_leaves(g_k), tree_leaves(g_p)):
        assert float((a - b_).norm()) <= 1e-3 * float(b_.norm())


#: (B, H, Hkv, S, D): qwen2-vl-7b's attention (28 heads on 4 kv heads,
#: a GQA group of 7, head dim 128) at small S, one ragged
CUDA_FLASH_GQA7_CASES = [(1, 28, 4, 200, 128), (2, 7, 1, 130, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_FLASH_GQA7_CASES)
def test_cuda_flash_at_a_gqa_group_of_7(case, h100, rng):
    """Causal, float32, with and without lse: out within 1e-4 of max(1,
    max|plain|), the same bits twice and with lse; lse within 1e-5 of
    max(1, |lse|) of the plain version's."""
    from repro_torch.kernels import flash_attention as FA
    b, h, hkv, s, d = case
    q, k, v = (t.to(h100) for t in map(
        torch.from_numpy, _qkv(rng, b, h, hkv, s, s, d)))
    got = FA.flash_attention(q, k, v)
    again = FA.flash_attention(q, k, v)
    o_lse, lse = FA.flash_attention(q, k, v, return_lse=True)
    want, want_lse = ref.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _flash_close(got, want, 1e-4, str(case))
    assert torch.equal(got, again) and torch.equal(got, o_lse)
    err = (lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-5, f"{case} lse {float(err.max())}"


@pytest.mark.cuda
def test_cuda_qwen2_vl_reduced_prefill_decode_and_gradient(h100):
    """Reduced qwen2-vl on the card with a vision layout of (3, B, S)
    M-RoPE positions: the prefill step through the kernel against the
    plain route, within 1e-4 of max(1, max|plain|), one flash launch a
    layer; 8 decode steps of text positions against the plain forward's
    logits; the gradient within 1e-3 of each leaf's norm of the plain
    route's, one flash launch with lse a layer."""
    from repro_torch import configs
    from repro_torch.configs.qwen2_vl_7b import vision_positions
    from repro_torch.core import prng
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import base as MB
    from repro_torch.optim import tree_leaves
    from repro_torch.train import step as TS
    m = configs.get_reduced("qwen2-vl-7b")
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, h100)
    g = torch.Generator(device=h100).manual_seed(0)
    toks = torch.randint(0, m.vocab, (2, 48), generator=g, device=h100)
    batch = {"tokens": toks,
             "positions": vision_positions(2, 48, 4, 4, device=h100)}
    before = FA.flash_attention.launches
    got = TS.make_prefill_step(m)(params, batch)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + m.n_layers
    want = TS.make_prefill_step(m, use_fused=False)(params, batch)
    _flash_close(got, want, 1e-4, "prefill")
    dec = TS.make_decode_step(m)
    states = MB.init_decode_state(params, m, 2, 16)
    for t in range(8):
        logits, states = dec(params, toks[:, t:t + 1], t, states)
    full = MB.forward(params, m, toks[:, :8], use_fused=False)
    _flash_close(logits[:, 0], full[:, 7], 1e-4, "decode")
    batch["labels"] = torch.roll(toks, -1, 1)
    before = FA.flash_attention.lse_launches
    loss_k, g_k = TS.loss_and_grads(m, params, batch)
    assert FA.flash_attention.lse_launches == before + m.n_layers
    loss_p, g_p = TS.loss_and_grads(m, params, batch, use_fused=False)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for a, b_ in zip(tree_leaves(g_k), tree_leaves(g_p)):
        assert float((a - b_).norm()) <= 1e-3 * float(b_.norm())


#: (B, S, Di, N): the selective scan's shapes; ragged tiles of the time
#: axis and of the channels, every state size it is built for, and
#: hymba-1.5b's prefill layer
CUDA_SSM_CASES = [(1, 1, 3, 4), (2, 33, 17, 8), (1, 100, 40, 16),
                  (3, 64, 8, 32), (2, 4096, 3200, 16)]


def _ssm_inputs(rng, b, s, di, n, device):
    """dt, bmat, cmat, x, a, h0 at a decoder's magnitudes (dt a softplus
    near the init's 0.01, a = -(1 .. N))."""
    dt = np.log1p(np.exp(rng.normal(-4.6, 0.5, size=(b, s, di))))
    a = -np.tile(np.arange(1, n + 1), (di, 1))
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (dt, rng.normal(size=(b, s, n)),
                           rng.normal(size=(b, s, n)),
                           rng.normal(size=(b, s, di)), a,
                           rng.normal(size=(b, di, n)) * 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_SSM_CASES)
def test_cuda_ssm_scan_matches_plain(case, h100, rng):
    """ys and the final state within 1e-4·max(1, max|plain|) of the plain
    loop, two calls the same bits, one launch a call."""
    from repro_torch.kernels import ssm_scan as SS
    args = _ssm_inputs(rng, *case, h100)
    before = SS.ssm_scan.launches
    got, again = SS.ssm_scan(*args), SS.ssm_scan(*args)
    want = ref.ssm_scan(*args)
    torch.cuda.synchronize()
    assert SS.ssm_scan.launches == before + 2
    for name, g, a, w in zip(("ys", "h"), got, again, want):
        assert bool(torch.isfinite(g).all()), name
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, (case, name)
        assert torch.equal(g, a), f"{case} {name}: two calls differ"


@pytest.mark.cuda
def test_cuda_ssm_scan_rejects_bad_input_and_differentiates(h100, rng):
    """A CUDA input that needs a gradient reaches ``SSMScanFn`` (the
    forward kernel, then the backward kernel: one launch each), through
    the wrapper and through ``ops``; ``use_fused=False`` is the plain loop
    under autograd.  An unsupported state size, dtype, layout or device
    raises, in the forward and in the backward."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as SS
    args = _ssm_inputs(rng, 1, 8, 4, 4, h100)
    for fn in (SS.ssm_scan, ops.ssm_scan):
        live = [args[0].clone().requires_grad_(True), *args[1:]]
        before = (SS.ssm_scan.launches, SS.ssm_scan_bwd.launches)
        y, _ = fn(*live)
        assert type(y.grad_fn).__name__ == "SSMScanFnBackward"
        y.sum().backward()
        torch.cuda.synchronize()
        assert (SS.ssm_scan.launches, SS.ssm_scan_bwd.launches) == \
            (before[0] + 1, before[1] + 1)
        assert live[0].grad is not None and live[3].grad is None
    live = [args[0].clone().requires_grad_(True), *args[1:]]
    y, _ = ops.ssm_scan(*live, use_fused=False)     # the plain loop, asked
    assert y.requires_grad and "SSMScanFn" not in type(y.grad_fn).__name__
    with torch.no_grad():
        SS.ssm_scan(*live)
    bad = _ssm_inputs(rng, 1, 8, 4, 5, h100)
    with pytest.raises(ValueError, match="state size"):
        SS.ssm_scan(*bad)
    with pytest.raises(TypeError):
        SS.ssm_scan(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        SS.ssm_scan(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                    *args[1:])
    with pytest.raises(ValueError):
        SS.ssm_scan(args[0], args[1].cpu(), *args[2:])
    _, _, h_chunks = SS.ssm_scan_fwd(*args)
    dys = torch.ones_like(args[0])
    with pytest.raises(ValueError, match="h_chunks"):
        SS.ssm_scan_bwd(*args[:5], h_chunks[:, :0], dys)
    with pytest.raises(ValueError, match="dys"):
        SS.ssm_scan_bwd(*args[:5], h_chunks, dys[:, 1:])
    with pytest.raises(TypeError):
        SS.ssm_scan_bwd(*args[:5], h_chunks, dys.double())
    with pytest.raises(ValueError):
        SS.ssm_scan_bwd(*args[:5], h_chunks, dys.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_SSM_CASES)
def test_cuda_ssm_scan_backward_matches_plain(case, h100, rng):
    """``SSMScanFn`` on the card (the forward kernel with its chunk
    states, then the backward kernel) against torch's autograd of the
    plain loop, every input needing a gradient and both outputs given a
    cotangent: ys and h, and the six gradients, within
    1e-4·max(1, max|plain|); two calls the same bits; one backward launch
    a call.  The forward's chunk states within the same tolerance of the
    plain loop's, and its ys and h the same bits as without them."""
    from repro_torch.kernels import ssm_scan as SS
    b, s, di, n = case
    args = _ssm_inputs(rng, *case, h100)
    dys = torch.tensor(rng.normal(size=(b, s, di)), dtype=torch.float32,
                       device=h100)
    dh = torch.tensor(rng.normal(size=(b, di, n)), dtype=torch.float32,
                      device=h100)

    def vjp(fn):
        live = [t.clone().requires_grad_(True) for t in args]
        y, h = fn(*live)
        grads = torch.autograd.grad((y * dys).sum() + (h * dh).sum(), live)
        return [y.detach(), h.detach(), *grads]

    before = SS.ssm_scan_bwd.launches
    got, again = vjp(SS.ssm_scan), vjp(SS.ssm_scan)
    torch.cuda.synchronize()
    assert SS.ssm_scan_bwd.launches == before + 2
    want = vjp(ref.ssm_scan)
    names = ("ys", "h", "d_dt", "d_bmat", "d_cmat", "d_x", "d_a", "d_h0")
    for name, g, a, w in zip(names, got, again, want):
        assert bool(torch.isfinite(g).all()), (case, name)
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, (case, name)
        assert torch.equal(g, a), f"{case} {name}: two calls differ"
    ys, h, h_chunks = SS.ssm_scan_fwd(*args)
    alone = SS.ssm_scan_fwd(*args, boundaries=False)
    assert torch.equal(ys, alone[0]) and torch.equal(h, alone[1])
    _, _, want_chunks = ref.ssm_scan(*args, boundaries=True)
    scale = max(1.0, float(want_chunks.abs().max()))
    assert float((h_chunks - want_chunks).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_hymba_train_steps(h100):
    """Reduced hymba on the card from the seed's params, the kernel route
    (flash with lse, ``SSMScanFn``'s two kernels) against the plain route
    (``use_fused=False``): one gradient, each leaf within 1e-3 of its norm
    (the gate of ``chip_smoke.py``'s full-width gradients); then 3
    ``make_train_step`` steps each, the losses within 1e-5 relative, with
    one flash launch with lse an attention layer and one scan forward and
    one scan backward an SSM layer, a step.  (Adam's update is near ±lr
    for an element whose gradient is near zero, so the params after a step
    are not compared element by element.)"""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.models import base as MB
    from repro_torch.optim import tree_leaves
    from repro_torch.train import step as TS
    m = configs.get_reduced("hymba-1.5b")
    g = torch.Generator().manual_seed(0)
    batches = [{k: torch.randint(0, m.vocab, (2, 64), generator=g).to(h100)
                for k in ("tokens", "labels")} for _ in range(3)]
    counters = lambda: (FA.flash_attention.lse_launches,  # noqa: E731
                        SS.ssm_scan.launches, SS.ssm_scan_bwd.launches)
    runs = {}
    for route, fused in (("kernel", None), ("plain", False)):
        params = MB.init_params(prng.prng_key(torch.tensor(0)), m, h100)
        _, grads = TS.loss_and_grads(m, params, batches[0],
                                     use_fused=fused)
        step, optim = TS.make_train_step(m, lr=1e-3, remat=False,
                                         use_fused=fused)
        opt = optim.init(params)
        before = counters()
        losses = []
        for b_ in batches:
            params, opt, met = step(params, opt, b_)
            losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        runs[route] = (losses, tree_leaves(grads), tuple(
            x - y for x, y in zip(counters(), before)))
    n_ssm = sum(seg.repeats for seg in m.segments for sp in seg.pattern
                if sp.cfg.ssm_state)
    assert runs["kernel"][2] == (3 * m.n_layers, 3 * n_ssm, 3 * n_ssm)
    assert runs["plain"][2] == (0, 0, 0)
    for a, b_ in zip(runs["kernel"][1], runs["plain"][1]):
        assert float((a - b_).norm()) <= 1e-3 * max(float(b_.norm()), 1e-30)
    np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0],
                               rtol=1e-5)


#: (B, S, D, H): the sLSTM kernel's shapes: the reduced widths (d 64 at
#: H 4, 2 and 1), a chunk-sized and a ragged length, every row count up
#: to the kernel's 8, and xlstm-1.3b's Engine step (4, 1) and prefill
#: (2, 4096) layers
CUDA_SLSTM_CASES = [(2, 12, 64, 4), (1, 128, 64, 2), (3, 37, 64, 1),
                    (8, 5, 256, 4), (5, 3, 128, 2), (6, 2, 64, 4),
                    (7, 2, 64, 4), (4, 1, 2048, 4), (2, 4096, 2048, 4)]


def _slstm_inputs(rng, b, s, d, h, device):
    """wx, rh, bias and a state (c, n, m, h) at an xLSTM layer's
    magnitudes: rh at the init's (1/dh)^0.5, the init's bias, n > 0."""
    dh = d // h
    bias = np.concatenate([np.zeros(2 * d), np.full(d, 3.0), np.zeros(d)])
    state = (rng.normal(size=(b, d)), np.abs(rng.normal(size=(b, d))) + 1e-6,
             rng.normal(size=(b, d)), rng.normal(size=(b, d)) * 0.1)
    wx, rh = rng.normal(size=(b, s, 4 * d)), rng.normal(size=(h, dh, 4 * dh))
    as_t = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                  device=device)
    return (as_t(wx), as_t(rh * (1.0 / dh) ** 0.5), as_t(bias),
            tuple(as_t(v) for v in state))


@pytest.mark.cuda
def test_cuda_slstm_scan_takes_rows_in_groups(h100, rng):
    """A batch of more than ``MAX_BATCH`` rows runs in groups of up to 8,
    one launch a group each way: hs, the final state, the chunk states
    and every gradient within 1e-4·max(1, max|plain|) of the plain loop's,
    and each group's rows the bits of the group launched alone."""
    from repro_torch.kernels import slstm_scan as SL
    b, s, d, h = 11, 70, 64, 4
    wx, rh, bias, state = _slstm_inputs(rng, b, s, d, h, h100)
    dys = torch.randn(b, s, d, device=h100)
    before = (SL.slstm_scan.launches, SL.slstm_scan_bwd.launches)
    hs, fin, chunks = SL.slstm_scan_fwd(wx, rh, bias, state)
    got = SL.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys)
    torch.cuda.synchronize()
    assert (SL.slstm_scan.launches, SL.slstm_scan_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    tail = SL.slstm_scan_fwd(wx[8:], rh, bias, tuple(t[8:] for t in state))
    assert torch.equal(hs[8:], tail[0])
    plain = ref.slstm_scan(wx, rh, bias, state, boundaries=True)
    want = ref.slstm_scan_bwd(wx, rh, bias, state, plain[0], plain[2], dys)
    for g, w in zip((hs, *fin, *chunks, *got),
                    (plain[0], *plain[1], *plain[2], *want)):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_SLSTM_CASES)
def test_cuda_slstm_scan_matches_plain(case, h100, rng):
    """hs and the final (c, n, m, h) within 1e-4·max(1, max|plain|) of the
    plain loop, two calls the same bits, one launch a call."""
    from repro_torch.kernels import slstm_scan as SL
    wx, rh, bias, state = _slstm_inputs(rng, *case, h100)
    before = SL.slstm_scan.launches
    got = SL.slstm_scan(wx, rh, bias, state)
    again = SL.slstm_scan(wx, rh, bias, state)
    want = ref.slstm_scan(wx, rh, bias, state)
    torch.cuda.synchronize()
    assert SL.slstm_scan.launches == before + 2
    flat = lambda r: (r[0], *r[1])  # noqa: E731
    for name, g, a, w in zip(("hs", "c", "n", "m", "h"), flat(got),
                             flat(again), flat(want)):
        assert bool(torch.isfinite(g).all()), name
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, (case, name)
        assert torch.equal(g, a), f"{case} {name}: two calls differ"
    assert torch.equal(got[0][:, -1], got[1][3])


@pytest.mark.cuda
def test_cuda_slstm_scan_rejects_what_it_does_not_take(h100, rng,
                                                       monkeypatch):
    """A shape, dtype, layout, device or card the kernels do not take
    raises, in the forward and in the backward; inputs that need a
    gradient reach ``SLSTMScanFn`` (one forward and one backward launch),
    through the wrapper and through ``ops``; ``use_fused=False`` is the
    plain loop under autograd."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import slstm_scan as SL
    wx, rh, bias, state = _slstm_inputs(rng, 2, 4, 64, 4, h100)
    before = SL.slstm_scan.launches
    with pytest.raises(ValueError, match="rows"):
        SL.slstm_scan(*_slstm_inputs(rng, 0, 2, 64, 4, h100))
    with pytest.raises(ValueError, match="multiple"):
        SL.slstm_scan(*_slstm_inputs(rng, 1, 2, 40, 4, h100))
    with pytest.raises(ValueError, match="dh one of"):
        SL.slstm_scan(*_slstm_inputs(rng, 1, 2, 96, 16, h100))
    with pytest.raises(ValueError, match="dh one of"):
        SL.slstm_scan(*_slstm_inputs(rng, 1, 2, 96, 2, h100))
    with pytest.raises(ValueError, match="shared memory"):
        SL.slstm_scan(*_slstm_inputs(rng, 8, 1, 8192, 16, h100))
    with pytest.raises(ValueError, match="bias"):
        SL.slstm_scan(wx, rh, bias[1:], state)
    with pytest.raises(ValueError, match="h has shape"):
        SL.slstm_scan(wx, rh, bias, (*state[:3], state[3][:1]))
    with pytest.raises(TypeError):
        SL.slstm_scan(wx.double(), rh, bias, state)
    with pytest.raises(ValueError, match="contiguous"):
        SL.slstm_scan(wx.transpose(0, 1).contiguous().transpose(0, 1), rh,
                      bias, state)
    with pytest.raises(ValueError, match="is on"):
        SL.slstm_scan(wx, rh.cpu(), bias, state)
    assert SL.slstm_scan.launches == before
    for fn in (SL.slstm_scan, ops.slstm_scan):
        live = wx.clone().requires_grad_(True)
        counts = (SL.slstm_scan.launches, SL.slstm_scan_bwd.launches)
        hs, _ = fn(live, rh, bias, state)
        assert type(hs.grad_fn).__name__ == "SLSTMScanFnBackward"
        hs.sum().backward()
        torch.cuda.synchronize()
        assert (SL.slstm_scan.launches, SL.slstm_scan_bwd.launches) == \
            (counts[0] + 1, counts[1] + 1)
        assert live.grad is not None
    live = wx.clone().requires_grad_(True)
    hs, _ = ops.slstm_scan(live, rh, bias, state, use_fused=False)
    assert "SLSTMScanFn" not in type(hs.grad_fn).__name__
    hs.sum().backward()
    assert live.grad is not None
    hs, _, chunks = SL.slstm_scan_fwd(wx, rh, bias, state)
    dys = torch.ones_like(hs)
    with pytest.raises(ValueError, match="c_chunks"):
        SL.slstm_scan_bwd(wx, rh, bias, state, hs,
                          (chunks[0][:, :0], *chunks[1:]), dys)
    with pytest.raises(ValueError, match="dys"):
        SL.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys[:, 1:])
    with pytest.raises(ValueError, match="dh has shape"):
        SL.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys,
                          (None, None, None, dys[:, 0, :1]))
    with pytest.raises(TypeError):
        SL.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys.double())
    with pytest.raises(ValueError, match="is on"):
        SL.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys.cpu())
    big = _slstm_inputs(rng, 8, 1, 8192, 16, h100)
    with pytest.raises(ValueError, match="shared memory"):
        SL.slstm_scan_bwd(*big, torch.empty(8, 1, 8192, device=h100),
                          tuple(torch.empty(8, 1, 8192, device=h100)
                                for _ in range(3)))
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (8, 0))
    with pytest.raises(RuntimeError, match="sm_90a"):
        SL.slstm_scan(wx, rh, bias, state)


#: (B, S, D, H): the backward's shapes: the reduced widths, lengths that
#: cross a chunk of 64 or end inside one, 8 rows, dh 512 past a chunk,
#: and xlstm-1.3b's train step layer (2, 2048)
CUDA_SLSTM_BWD_CASES = [(2, 12, 64, 4), (1, 128, 64, 2), (3, 100, 64, 1),
                        (8, 5, 256, 4), (2, 130, 2048, 4),
                        (2, 2048, 2048, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_SLSTM_BWD_CASES)
def test_cuda_slstm_scan_backward_matches_plain(case, h100, rng):
    """The backward kernel on the forward kernel's chunk states against
    ``ref.slstm_scan_bwd`` on the plain loop's, every cotangent given:
    d_wx, d_rh, d_bias and the initial state's four within
    1e-4·max(1, max|plain|), two calls the same bits, one launch a call.
    The forward's chunk states within the same of the plain loop's, and
    its hs and final state the same bits as without them.  Then
    ``SLSTMScanFn``'s outputs and gradients against torch's autograd of
    the plain loop, within the same tolerance."""
    from repro_torch.kernels import slstm_scan as SL
    b, s, d, h = case
    wx, rh, bias, state = _slstm_inputs(rng, *case, h100)
    as_t = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                  device=h100)
    dys = as_t(rng.normal(size=(b, s, d)))
    d_state = tuple(as_t(rng.normal(size=(b, d))) for _ in range(4))
    hs, fin, chunks = SL.slstm_scan_fwd(wx, rh, bias, state)
    alone = SL.slstm_scan_fwd(wx, rh, bias, state, boundaries=False)
    assert torch.equal(hs, alone[0])
    assert all(torch.equal(x, y) for x, y in zip(fin, alone[1]))
    _, _, want_chunks = ref.slstm_scan(wx, rh, bias, state, boundaries=True)
    for name, g, w in zip("cnm", chunks, want_chunks):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, (case, name)
    before = SL.slstm_scan_bwd.launches
    got = SL.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys, d_state)
    again = SL.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys, d_state)
    torch.cuda.synchronize()
    assert SL.slstm_scan_bwd.launches == before + 2
    plain_hs, _, plain_chunks = ref.slstm_scan(wx, rh, bias, state,
                                               boundaries=True)
    want = ref.slstm_scan_bwd(wx, rh, bias, state, plain_hs, plain_chunks,
                              dys, d_state)
    names = ("d_wx", "d_rh", "d_bias", "dc0", "dn0", "dm0", "dh0")
    for name, g, a, w in zip(names, got, again, want):
        assert bool(torch.isfinite(g).all()), (case, name)
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, (case, name)
        assert torch.equal(g, a), f"{case} {name}: two calls differ"

    def vjp(fn):
        live = [t.clone().requires_grad_(True) for t in (wx, rh, bias,
                                                          *state)]
        out, st = fn(*live[:3], tuple(live[3:]))
        loss = (out * dys).sum() + sum((x * g).sum()
                                       for x, g in zip(st, d_state))
        return [out.detach(), *torch.autograd.grad(loss, live)]

    got, want = vjp(SL.slstm_scan), vjp(ref.slstm_scan)
    for name, g, w in zip(("hs",) + names, got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale, (case, name)


@pytest.mark.cuda
def test_cuda_xlstm_train_steps(h100):
    """Reduced xlstm on the card from the seed's params, the kernel route
    (``SLSTMScanFn``'s two kernels, remat on) against the plain route
    (``use_fused=False``): one gradient, each leaf within 1e-3 of
    max(its norm, 1e-6 x the whole gradient's norm) (the mLSTM's b_i is
    zero up to rounding); then 3 ``make_train_step`` steps each, the
    losses within 1e-5 relative, with two forward launches (remat) and
    one backward launch an sLSTM layer a step."""
    from repro_torch import configs
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.models import base as MB
    from repro_torch.optim import tree_leaves
    from repro_torch.train import step as TS
    m = configs.get_reduced("xlstm-1.3b")
    n_sl = sum(seg.repeats for seg in m.segments for sp in seg.pattern
               if sp.kind == "slstm")
    g = torch.Generator().manual_seed(0)
    batches = [{k: torch.randint(0, m.vocab, (2, 128), generator=g).to(h100)
                for k in ("tokens", "labels")} for _ in range(3)]
    counters = lambda: (SL.slstm_scan.launches,  # noqa: E731
                        SL.slstm_scan_bwd.launches)
    runs = {}
    for route, fused in (("kernel", None), ("plain", False)):
        params = MB.init_params(prng.prng_key(torch.tensor(0)), m, h100)
        _, grads = TS.loss_and_grads(m, params, batches[0], remat=True,
                                     use_fused=fused)
        step, optim = TS.make_train_step(m, lr=1e-3, use_fused=fused)
        opt = optim.init(params)
        before = counters()
        losses = []
        for b_ in batches:
            params, opt, met = step(params, opt, b_)
            losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        runs[route] = (losses, tree_leaves(grads), tuple(
            x - y for x, y in zip(counters(), before)))
    assert runs["kernel"][2] == (3 * 2 * n_sl, 3 * n_sl)
    assert runs["plain"][2] == (0, 0)
    total = float(torch.stack([x.norm() for x in runs["plain"][1]]).norm())
    for a, b_ in zip(runs["kernel"][1], runs["plain"][1]):
        assert float((a - b_).norm()) <= 1e-3 * max(float(b_.norm()),
                                                    1e-6 * total)
    np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0],
                               rtol=1e-5)


@pytest.mark.cuda
def test_cuda_xlstm_reduced_forward_and_decode(h100):
    """Reduced xlstm on the card from the seed's params: the forward at S
    128 (chunkwise mLSTM) and 12 (stepwise) through the kernel (one sLSTM
    launch a layer) within 1e-4·scale of the plain route; 12 decode steps
    (one launch an sLSTM layer a step) within the same of the stepwise
    forward."""
    from repro_torch import configs
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.models import base as MB
    m = configs.get_reduced("xlstm-1.3b")
    n_sl = sum(seg.repeats for seg in m.segments for sp in seg.pattern
               if sp.kind == "slstm")
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, h100)
    g = torch.Generator().manual_seed(0)
    for s in (128, 12):
        toks = torch.randint(0, m.vocab, (2, s), generator=g).to(h100)
        before = SL.slstm_scan.launches
        with torch.no_grad():
            got = MB.forward(params, m, toks)
            want = MB.forward(params, m, toks, use_fused=False)
        assert SL.slstm_scan.launches == before + n_sl
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-4 * scale, s
    states = MB.init_decode_state(params, m, 2, 16)
    before = SL.slstm_scan.launches
    with torch.no_grad():
        for t in range(toks.shape[1]):
            logits, states = MB.decode_step(params, m, toks[:, t:t + 1], t,
                                            states)
            assert float((logits[:, 0] - want[:, t]).abs().max()) <= \
                1e-4 * scale, t
    assert SL.slstm_scan.launches == before + n_sl * toks.shape[1]
