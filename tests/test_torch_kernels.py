"""The port's whole-MLP forward against the reference package.

On the CPU the port's wrapper takes its plain version; these tests hold
that plain version (and the dispatch around it) to the reference's Pallas
megakernel in interpret mode and to its jnp oracle, on the same numpy
inputs.  Tolerance: atol = rtol = 1e-5, float32 sums taken in another
order.

The ``cuda`` tests hold the CUDA kernel to the plain version on an H100
and skip elsewhere; they import nothing of the reference package, so they
run on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch as D
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
    gen = torch.Generator().manual_seed(0)
    p = L.mlp_init(gen, 16, [256, 256], 29, "cpu")
    assert [tuple(q["w"].shape) for q in p["layers"]] == \
        [(16, 256), (256, 256), (256, 29)]
    assert all(float(q["b"].abs().max()) == 0.0 for q in p["layers"])
    # He init on hidden layers, 1/sqrt(fan_in) on the head
    assert abs(float(p["layers"][1]["w"].std()) - (2 / 256) ** 0.5) < 0.01
    assert abs(float(p["layers"][2]["w"].std()) - (1 / 256) ** 0.5) < 0.01
    again = L.mlp_init(torch.Generator().manual_seed(0), 16, [256, 256], 29,
                       "cpu")
    assert torch.equal(again["layers"][0]["w"], p["layers"][0]["w"])


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
    """The K split depends on K alone, so a row's bits are the same in a
    64-row call and a 3-row call (what keeps a task's Selection
    independent of its batch)."""
    ws, bs = _mlp(rng, [16, 2048, 2048, 73])
    x = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    tw = [torch.from_numpy(w).to(h100) for w in ws]
    tb = [torch.from_numpy(b).to(h100) for b in bs]
    full = FM.fused_mlp(x.to(h100), tw, tb)
    part = FM.fused_mlp(x[5:8].contiguous().to(h100), tw, tb)
    assert torch.equal(full[5:8], part)


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
