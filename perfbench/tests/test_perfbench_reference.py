"""The reference against the port at small sizes on the CPU, and the
counts against hand counts at Table 4's widths."""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.lib import counts, harness, inputs
from perfbench.reference import gan as ref_gan
from perfbench.reference import select as ref_select
from perfbench.reference import threefry
from perfbench.reference.oracles import Oracle
from perfbench.tests import smallrun

MODELS = {"im2col": "Im2colModel", "dnnweaver": "DnnWeaverModel"}


def port_model(name):
    import importlib
    mod = importlib.import_module(f"repro_torch.design_models.{name}")
    return getattr(mod, MODELS[name])()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_oracles_are_the_ports_bit_for_bit(name):
    ref, port = Oracle(name), port_model(name)
    rng = np.random.default_rng(3)
    net, cfg = ref.net.sample(rng, 4000), ref.cfg.sample(rng, 4000)
    assert ref.cfg.choices == tuple(d.choices for d in port.space.dims)
    assert ref.net.choices == tuple(d.choices for d in port.net_space.dims)
    for a, b in zip(ref.host(net, cfg), port.evaluate_indices(net, cfg)):
        np.testing.assert_array_equal(a, b)
    tn, tc = torch.as_tensor(net), torch.as_tensor(cfg)
    for a, b in zip(ref.device(tn, tc), port.evaluate_torch_indices(tn, tc)):
        assert torch.equal(a, b)


def test_noise_is_the_ports_bit_for_bit():
    from repro_torch.core import gan as G
    from repro_torch.core import prng
    from repro_torch.core.explorer import task_keys
    seeds = np.array([0, 9, 2**31 + 7, 2**40 + 3], np.int64)
    cfg = G.GANConfig(n_net=6)
    want = G.sample_noise(prng.fold_in(task_keys(seeds, 4)[:, None, :],
                                       torch.zeros(1, dtype=torch.int64)), cfg)
    got = ref_gan.explore_noise(seeds, 8, "cpu")
    assert torch.equal(got, want[:, 0])
    rng, nrng = prng.split(prng.prng_key(torch.tensor(2**33 + 1)))
    k = threefry.split(threefry.key(2**33 + 1))
    assert torch.equal(k[0], rng) and torch.equal(k[1], nrng)
    assert torch.equal(threefry.uniform(k[1], 512 * 8, -0.1, 0.1).reshape(
        512, 8), G.sample_train_noise(nrng, 512, cfg))


@pytest.mark.parametrize("cap", [4096, 7])
def test_candidates_are_the_ports(cap):
    from repro_torch.core.explorer import enumerate_candidates
    port = port_model("im2col")
    sizes = Oracle("im2col").cfg.sizes
    rng = np.random.default_rng(cap)
    for _ in range(40):
        logits = rng.normal(size=sum(sizes)) * 1.5
        probs = ref_gan.group_softmax(sizes, torch.as_tensor(logits)).float()
        p = probs.numpy()
        got = ref_select.candidates(ref_select.employed(sizes, p, 0.2, cap))
        want = enumerate_candidates(port.space, p, 0.2, cap)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_answers_are_the_ports(name):
    from repro_torch.core.explorer import ExplorerConfig
    from repro_torch.core.fused_select import select_from_probs
    oracle, port = Oracle(name), port_model(name)
    tasks = inputs.tasks(oracle, 64, 11, 64, (1.0, 2.5))[0]
    logits = torch.randn(64, oracle.cfg.width, generator=torch.Generator()
                         .manual_seed(1), dtype=torch.float64) * 2
    probs = ref_gan.group_softmax(oracle.cfg.sizes, logits).float()
    sels = select_from_probs(port, tasks.net_idx, probs, ExplorerConfig(),
                             tasks.lat_obj, tasks.pow_obj)
    from perfbench.drivers.explore import as_answer
    got = ref_select.explore(oracle, tasks.net_idx, probs.numpy(), 0.2, 4096,
                             tasks.lat_obj, tasks.pow_obj, "cpu")
    assert got == [as_answer(s) for s in sels]
    assert sum(a[3] for a in got) > 0


def test_a_tie_counts_either_way():
    """A choice within `tie` of the threshold may be kept or dropped; one
    farther off may not."""
    oracle, tie = Oracle("im2col"), 1e-5
    sizes = oracle.cfg.sizes
    tasks = inputs.tasks(oracle, 8, 11, 8, (1.0, 2.5))[0]
    logits = torch.randn(8, oracle.cfg.width, generator=torch.Generator()
                         .manual_seed(4), dtype=torch.float64)
    probs = ref_gan.group_softmax(sizes, logits).numpy()
    j = int(np.argsort(probs[0, :sizes[0]])[-2])     # not the group's best

    def answer(pj):
        p = probs.copy()
        p[0, j] = pj
        return ref_select.explore(oracle, tasks.net_idx, p, 0.2, 4096,
                                  tasks.lat_obj, tasks.pow_obj, "cpu")[0], p

    kept, p_near = answer(0.2 + 0.4 * tie)
    dropped, _ = answer(0.2 - 0.4 * tie)
    assert kept != dropped
    ok = ref_select.explore_ties(oracle, tasks.net_idx, p_near, 0.2, 4096,
                                 tasks.lat_obj, tasks.pow_obj, "cpu", tie)
    assert {kept, dropped} <= ok[0]
    _, p_far = answer(0.2 + 20 * tie)
    ok = ref_select.explore_ties(oracle, tasks.net_idx, p_far, 0.2, 4096,
                                 tasks.lat_obj, tasks.pow_obj, "cpu", tie)
    assert dropped not in ok[0]


def test_g_probs_are_the_ports():
    from repro_torch.core import gan as G
    oracle = Oracle("im2col")
    dims = inputs.mlp_dims(16, 3, 64, oracle.cfg.width)
    layers = inputs.weights(dims, 4, inputs.WEIGHTS_G, "cpu")
    x = torch.randn(32, 16, generator=torch.Generator().manual_seed(2))
    port = G.generator_apply(
        {"layers": [{"w": w, "b": b} for w, b in layers]},
        port_model("im2col").space, x[:, :6], x[:, 6:8], x[:, 8:],
        use_fused=False, chained=True)
    ref = ref_gan.g_probs([(w.double(), b.double()) for w, b in layers],
                          oracle.cfg.sizes, x[:, :6], x[:, 6:8], x[:, 8:],
                          "float64")
    assert float((port.double() - ref).abs().max()) < 1e-6


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      smallrun.bench()["workloads"]])
def test_a_small_run_of_the_port_is_correct(workload):
    driver, run = smallrun.make(workload, seed=2**33 + 17)
    st = driver.setup(run)
    win = driver.window(st, 0.3, None)
    assert win.attempted > 0 and win.failed == 0
    assert all(v > 0 for v in win.e2e.values())
    checks = driver.check(st, win)
    assert smallrun.correct(checks), checks


def test_counts_by_hand_at_table4():
    g = inputs.mlp_dims(6 + 2 + 8, 11, 2048, 73)
    d = inputs.mlp_dims(6 + 73 + 2, 11, 2048, 2)
    g_products = 16 * 2048 + 10 * 2048 * 2048 + 2048 * 73
    ops, n_bytes = counts.mlp_forward_work(1024, g)
    assert ops == 2 * 1024 * g_products == 86_272_638_976
    assert n_bytes == 4 * (1024 * 16 + g_products + 11 * 2048 + 73
                           + 1024 * 73)
    assert counts.mlp_forward_bound_s(1024, g) == ops / 495e12
    d_products = 81 * 2048 + 10 * 2048 * 2048 + 2048 * 2
    g_dx = g_products - 16 * 2048
    d_dx = d_products - 81 * 2048
    step = counts.algorithm1_products(1024, g, d)
    # G: forward, dW, dx past the first layer; D: forward, dW, its own dx
    # past the first layer, the critic's dx through every layer
    assert counts.flops(step) == 2 * 1024 * (
        3 * g_products - 16 * 2048 + 3 * d_products + d_dx)
    assert counts.flops(step) == 2 * 1024 * (2 * g_products + g_dx
                                             + 3 * d_products + d_dx)
    big = (1024, 2048, 2048)
    assert counts.product_bytes(big) == 4 * 3 * 2048 * 1024 + 4 * 2048 * 1024
    assert counts.bound_s([big]) == 2 * 1024 * 2048 * 2048 / 495e12


def test_import_guard_compares_whole_names():
    mods = ["repro_torch", "repro_torch.core", "numpy", "jaxtyping", "reprox"]
    assert harness.forbidden_modules(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib", "flax.linen", "repro",
                "repro.core.gan"):
        assert harness.forbidden_modules(mods + [bad]) == [bad]


def test_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from perfbench.lib import harness; harness.import_reference(); "
            "import perfbench.lib.inputs, perfbench.lib.counts; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=smallrun.ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ exits non-zero
    and prints no result."""
    import shutil
    shutil.copy(smallrun.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(smallrun.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "im2col.explore.t1024", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout.strip() == ""
