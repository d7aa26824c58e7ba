"""The port's design models and dataset generator against the reference.

- The torch float32 oracle (``evaluate_torch``) against ``evaluate_jax``:
  bit-identical (exact equality, inf included) over the whole dnnweaver
  space (2744 configs) and sampled (T, C) grids for im2col and tpu_mesh.
- The numpy float64 ``evaluate`` copies against the reference's: exact.
- The dataset/task generator: the same seed gives the same rows.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dataset import generator as JGEN
from repro.design_models.dnnweaver import DnnWeaverModel as JDnnWeaver
from repro.design_models.im2col import Im2colModel as JIm2col
from repro.design_models.tpu_mesh import TpuMeshModel as JTpuMesh
from repro_torch.dataset import generator as GEN
from repro_torch.design_models import (DnnWeaverModel, Im2colModel,
                                       TpuMeshModel)

PAIRS = {
    "dnnweaver": (JDnnWeaver, DnnWeaverModel),
    "im2col": (JIm2col, Im2colModel),
    "tpu_mesh": (JTpuMesh, TpuMeshModel),
}


def _assert_bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _grid(jm, rng, n_nets, n_cfgs):
    """(T, 1, n_net) nets against (1, C, n_cfg) configs; dnnweaver takes
    its whole config space."""
    if n_cfgs is None:
        cfg = np.array(list(itertools.product(
            *[range(d.n) for d in jm.space.dims])), np.int32)
    else:
        cfg = jm.space.sample_indices(rng, n_cfgs).astype(np.int32)
    net = jm.net_space.sample_indices(rng, n_nets).astype(np.int32)
    return net[:, None, :], cfg[None]


@pytest.mark.parametrize("name,n_nets,n_cfgs", [
    ("dnnweaver", 48, None),         # all 2744 configs
    ("im2col", 48, 2048),
    ("tpu_mesh", 48, 2048),
])
def test_f32_oracle_bit_identical_to_evaluate_jax(name, n_nets, n_cfgs, rng):
    jm, tm = PAIRS[name][0](), PAIRS[name][1]()
    net, cfg = _grid(jm, rng, n_nets, n_cfgs)
    lj, pj = jm.evaluate_jax_indices(jnp.asarray(net), jnp.asarray(cfg))
    lt, pt = tm.evaluate_torch_indices(torch.from_numpy(net).long(),
                                       torch.from_numpy(cfg).long())
    assert lt.shape == (net.shape[0], cfg.shape[1])
    _assert_bits_equal(lt.numpy(), lj)
    _assert_bits_equal(pt.numpy(), pj)
    # the grid must exercise both feasible and infeasible configs
    fin = np.isfinite(np.asarray(lj))
    assert fin.any() and (name == "dnnweaver" or not fin.all())


def test_dnnweaver_f32_oracle_strided_sweep_of_all_nets():
    """dnnweaver's pow2floor is power(2, floor(log2(x))): a log2 one ulp
    low flips a tile.  Every 37th of the 3600 nets against all 2744
    configs."""
    jm, tm = JDnnWeaver(), DnnWeaverModel()
    nets = np.array(list(itertools.product(
        *[range(d.n) for d in jm.net_space.dims])), np.int32)[::37]
    cfg = np.array(list(itertools.product(
        *[range(d.n) for d in jm.space.dims])), np.int32)
    lj, pj = jm.evaluate_jax_indices(jnp.asarray(nets[:, None]),
                                     jnp.asarray(cfg[None]))
    lt, pt = tm.evaluate_torch_indices(torch.from_numpy(nets[:, None]).long(),
                                       torch.from_numpy(cfg[None]).long())
    _assert_bits_equal(lt.numpy(), lj)
    _assert_bits_equal(pt.numpy(), pj)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_f64_evaluate_copy_is_exact(name, rng):
    jm, tm = PAIRS[name][0](), PAIRS[name][1]()
    net = jm.net_space.sample_indices(rng, 512)
    cfg = jm.space.sample_indices(rng, 512)
    lj, pj = jm.evaluate_indices(net, cfg)
    lt, pt = tm.evaluate_indices(net, cfg)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(pt, pj)
    # broadcast (T, 1, ·) x (1, C, ·) grids too
    lj2, _ = jm.evaluate_indices(net[:8, None], cfg[None, :64])
    lt2, _ = tm.evaluate_indices(net[:8, None], cfg[None, :64])
    np.testing.assert_array_equal(lt2, lj2)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spaces_match_reference(name):
    jm, tm = PAIRS[name][0](), PAIRS[name][1]()
    for js, ts in ((jm.space, tm.space), (jm.net_space, tm.net_space)):
        assert [(d.name, d.choices) for d in js.dims] == \
            [(d.name, d.choices) for d in ts.dims]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_generator_same_seed_same_rows(name):
    jm, tm = PAIRS[name][0](), PAIRS[name][1]()
    jds, tds = JGEN.generate_dataset(jm, 300, seed=4), \
        GEN.generate_dataset(tm, 300, seed=4)
    for f in ("net_idx", "cfg_idx", "latency", "power"):
        np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
    for f in ("lat_norm", "pow_norm", "net_norm"):
        np.testing.assert_array_equal(getattr(tds, f).std,
                                      getattr(jds, f).std)
    np.testing.assert_array_equal(tds.net_encoded(tm), jds.net_encoded(jm))
    jt, tt = JGEN.generate_tasks(jm, 20, seed=2), \
        GEN.generate_tasks(tm, 20, seed=2)
    np.testing.assert_array_equal(tt.net_idx, jt.net_idx)
    np.testing.assert_array_equal(tt.lat_obj, jt.lat_obj)
    np.testing.assert_array_equal(tt.pow_obj, jt.pow_obj)
    np.testing.assert_array_equal(
        tds.obj_encoded(tt.lat_obj, tt.pow_obj),
        jds.obj_encoded(jt.lat_obj, jt.pow_obj))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_torch_space_twins_match_jnp(name, rng):
    jm, tm = PAIRS[name][0](), PAIRS[name][1]()
    idx = jm.space.sample_indices(rng, 40).astype(np.int32)
    _assert_bits_equal(
        tm.space.values_from_indices_torch(torch.from_numpy(idx).long())
        .numpy(),
        jm.space.values_from_indices_jax(jnp.asarray(idx)))
    flat = rng.random((5, jm.space.onehot_width)).astype(np.float32)
    jp, jmask = jm.space.split_groups_padded(jnp.asarray(flat), fill=-1.0)
    tp, tmask = tm.space.split_groups_padded(torch.from_numpy(flat),
                                             fill=-1.0)
    np.testing.assert_array_equal(tmask, jmask)
    _assert_bits_equal(tp.numpy(), jp)
